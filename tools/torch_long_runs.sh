#!/usr/bin/env bash
# The three long-run tools at the JAX package's recorded sizes, on the
# card, each a process of its own and all four at once: the steps are
# host-bound eager loops and the processes share the card without slowing
# one another.  Run from the root of a checkout:
#
#     bash tools/torch_long_runs.sh [OUT_DIR]    # default build/long_runs
#
# Ghia Re100 N=100 250,000 steps; the Nusselt legs at Ra 1e4 N=100 (up to
# 300,000 steps each, --leg cond and --leg conv); the FSI release at nx=30
# for 120,000 steps.  Each tool's log and its last JSON line go to
# OUT_DIR/<run>.log; rc.txt has each exit code and seconds.
D=${1:-build/long_runs}
mkdir -p "$D"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s)
python3 -c 'from sph_bvf_tpu_torch import _build
for n in ("pass_a_2d", "pass_a_2d_rowloop", "rebin_move_2d"): _build.load(n)'
echo "build $(( $(date +%s) - t0 )) s"
t0=$(date +%s)
run() {
    local name=$1; shift
    "$@" > "$D/$name.log" 2>&1
    echo "$name rc=$? $(( $(date +%s) - t0 )) s" >> "$D/rc.txt"
}
run ghia env GHIA_STEPS=250000 GHIA_N=100 GHIA_RE=100 \
    python3 tools/torch_ghia_benchmark.py &
run nu_cond python3 tools/torch_nusselt.py --N 100 --Ra 1e4 \
    --max-steps 300000 --leg cond &
run nu_conv python3 tools/torch_nusselt.py --N 100 --Ra 1e4 \
    --max-steps 300000 --leg conv &
run fsi python3 tools/torch_fsi_release.py --steps 120000 --every 10000 \
    --nx 30 --tdamp-solid 2e4 --out "$D/fsi_release_torch.npz" &
wait
cat "$D/rc.txt"
for name in ghia nu_cond nu_conv fsi; do
    echo "== $name"
    grep -vE '^\[(cond|conv)\] step' "$D/$name.log" | cut -c1-2000
done
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
