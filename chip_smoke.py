#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, check them, time them.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Six paths: the flagship lid-driven cavity (K1 pass A, K5 rebin move),
the FSI beam in a periodic-x channel (K2 pass A, K6 rebin move), the 3D
lid-driven cavity (K3 pass A, K7 rebin move), in-run load balancing on
the drifting blob (solid-free K2, K6 with non-uniform x columns), natural
convection around a hot cylinder (K1 with the species rows, K5 moving the
C rows) and cell polarization in a doubly periodic box (K2 with the fsi
pair style, the species rows and a periodic y axis, K6 with a periodic y
axis); K5 and K7 with x columns are checked on the cavities, K3 and K7
with species on the 3D cavity; the SDPD thermal noise (the thermal rows
of K1, K2 and K3) on natural convection at the reference's own e = 1e-6 and
on the flagship cavity with the noise made visible; the spanwise-
periodic 3D cavity (K3 and K7 with a periodic axis), written out as VTK
frames with per-atom computes and checkpointed and resumed; and two 3D
scenes built by ``Scene`` in either package: the spanwise-periodic 3D FSI
beam (K3 with the mechanics pair style, XSPH and free elastic solids, K7
past cap 64) and the triply periodic Taylor-Green vortex (K3 without
solids, K7 past cap 64); the rest of the grouped 2D kernel: the flagship
at N=1000 with ``preshift_window`` (K4, the window staged in shared
memory) and the
cavity under the mechanics pair style (K1's full body), with K1's full body
and K4 held on the FSI, polarization and blob states and the JAX package's
crowded-cell grid; and the last three kernel pieces: the doubly periodic 2D
Taylor-Green vortex (K2 solid-free with periodic x and y, K5 on both
periodic axes), the 3D drifting blob (K3 solid-free, K7 with x_edges on a
grid periodic in x and z) and K8, the window-rotation probe, through its
own entry point (``tools/torch_rotation_probe.py``).  Phases, one line
each:

1. device  — the card's name, and its name and power limit from nvidia-smi;
2. build   — compile the six hand-written kernel sources from
             ``sph_bvf_tpu_torch/csrc``, one nvcc per source, all at once,
             and print every pass-A instantiation's registers (with and
             without the thermal rows; K1, K4 and K3 with both pair
             bodies) and the moves' (K5 and K6 one kernel, which must
             show 0 local bytes, and K7's two);
3. K1      — the pass-A kernel against the plain stencil loop on the N=200
             cavity after setup and 100 steps, both filter variants:
             max|diff| <= 5e-6 * max|plain| for every field;
4. K5      — the rebin-move kernel against the plain walk and the sort
             rebin on that state 10 steps later: every leaf bitwise equal;
   K5 edges — that state sort-rebinned into x columns of alternating
             widths 7/8 and 9/8 of a cell (``tests/test_halo_kernels.py``'s
             construction), run 10 steps through ``simulate`` (rebinning
             every 2 steps through K5 with x_edges), then K5 against the
             plain walk and the sort rebin, bitwise, on that state and on
             a seeded drift of it with a tenth snapped onto column edges
             (timed on both; the run's state gives the kernel's ms);
   K1 species — K1 with the species rows (C in, the flux Q out) against the
             plain loop on natural_convection.build(N=200) after setup and
             after 200 steps, both filter variants, every field and Q within
             5e-6 * max|plain|: as run (Ns=1), with further species seeded
             from numpy (Ns=2 and the kernels' limit Ns=4, a distinct kappa
             per type pair) and with the species support cutc = 1.2 h and
             0.8 h; Q nonzero for every species in each case; then K5
             moving the C rows against the plain walk and the sort rebin,
             bitwise, 10 steps later (Ns=1 as run and Ns=2 seeded);
   K1 thermal — K1's thermal rows against the plain loop on that state
             (Ns=1, and Ns=0 with its species stripped) read at step 12345
             with a nonzero key, both filter variants, every field within
             5e-6 * max|plain|: (a) at the SI kB and e = 1e-6, (b) at the kB
             that makes the noise 20x the largest force without it; on (b)
             the noise present (>= 10x), pair-symmetric (its sum over an
             all-fluid copy with uniform e within 1e-6 x its max x
             sqrt(particles)) and changed by the next step;
5. K2      — the rowloop pass-A kernel against the plain loop on
             fsi.build(nx=60, tdamp_solid=100) after setup and 300 steps
             (the beam released at step 100), both filter variants, on that
             state and with the beam's S seeded from numpy (seed 0):
             max|diff| <= 5e-6 * max|plain| for every field, with the
             artificial-stress tensor AS and the stress rate dS nonzero;
   K1 full body — K1 (called directly, as the JAX package's tests call
             the grouped kernel with rowloop=False) against the plain loop
             on that FSI state as run and with S seeded (periodic x,
             mechanics, XSPH, the free elastic beam; AS, dS and ddx
             nonzero), both filter variants, 5e-6 * max|plain| per field,
             and K4 bitwise K1 on each; the same with the thermal rows
             (K1 full body thermal, as K1 thermal); on the polarization
             state (below: the fsi style, ampl_damp, the G0 row, Ns=1,
             periodic x and y) as run and seeded; on the balanced s=20
             blob (solid-free; phi, nw and dS exactly 0) as run and with
             rho and v seeded; and on the JAX package's crowded-cell grid
             (tests/test_pair_pallas.py:351-437, rebuilt from numpy:
             solid-free, lattice-aligned, routed to K1 by default), then 10
             steps of it through simulate (K1 11 launches, K5 2);
   K2 thermal — K2's thermal rows, as K1 thermal, on that FSI state
             (elastic, Ns=0) and (below, after K2 polarization) on the
             polarization state (elastic, Ns=1), then 10 steps of the
             polarization with the noise (K2's launches and its timing);
6. K6      — the rebin-move kernel at cap 47 against the plain walk and the
             sort rebin on that state 50 steps after its rebin: bitwise;
7. K3      — the 3D pass-A kernel against the plain 27-offset loop on
             lid_cavity3d.build(N) after setup and 100 steps, N=40 and the
             main path's N=100, both filter variants: max|diff| <= 5e-6 *
             max|plain| for every field;
8. K7      — the 3D rebin-move kernel against the plain walk and the sort
             rebin on each of those states 10 steps later: every leaf
             bitwise; K7 edges: as K5 edges, on the N=100 state;
   K3 species — K3 with the species rows against the plain loop on the
             N=40 state with C seeded from numpy (Ns=1, and Ns=2 with
             cutc = 1.2 h), Q included and nonzero; then 10 steps of
             ``simulate`` with those species and K7 moving the C rows
             against the plain walk and the sort rebin, bitwise;
   K3 thermal — K3's thermal rows, as K1 thermal, on the N=40 state (Ns=0
             and one seeded species), then 10 steps with the noise;
   K3 periodic — K3 against the plain loop with periodic axes, both filter
             variants, 5e-6 * max|plain| per field: on the spanwise cavity
             (y periodic) at N=40 after setup and 100 steps with x jittered
             by up to a tenth of a spacing (numpy, seed 1), and on a fully
             periodic box of 45^3 sites around a fixed sphere (cells of at
             most three spacings, cap 38; x, v and rho seeded) with one
             seeded species (Q included)
             and with the thermal rows, as K1 thermal;
   K7 periodic — K7 against the plain walk and the sort rebin, bitwise, on
             the spanwise state, on a channel periodic in x and z and on the
             box, each after a seeded drift of up to 0.9 cells that crosses
             every periodic face and, outward in the corner cells, every
             corner;
   K3 mechanics — K3 against the plain loop, 5e-6 * max|plain| per field,
             dS and ddx included, both filter variants, on the 3D FSI beam
             (fsi.build_spanwise(nx=30): x and z periodic, cap 208, a mixed
             lattice) released at step 10 and run 20 steps, as run and with
             the beam's S seeded (AS, dS, ddx and phi live);
   K3 fsi  — the same beam with the fsi pair style and one species
             (pair_style="fsi", kappa): K3 against the plain loop on five of
             K2 polarization's seeded cases (S, v, rho and C on the beam up
             to 1.5 seeded; one and two species, cutc 0.8 h with the
             advection correction, ampl_damp 0, the modulus coupling off),
             dS and Q included, then 10 steps with one species (K3's
             launches and timing);
   K3 solid-free — K3 against the plain loop on the Taylor-Green vortex
             (taylor_green3d.build(N=20): no solids, every axis periodic,
             cap 86) after 100 steps with x jittered by up to 0.1 spacing,
             phi, nw, dS and ddx exactly 0;
   K7 large cap — K7 against the plain walk and the sort rebin, bitwise, on
             the beam at nx=30 (cap 208; the run and a seeded seam drift),
             the vortex at N=20 (cap 86; likewise) and the beam at nx=60
             (cap 296, a seeded seam drift);
   K2 solid-free — the load-balance path's pass A: K2 against the plain
             loop on the balanced s=20 drifting blob (840,000 particles,
             x_edges, periodic x, no solids) after setup and 100 steps of
             ``simulate`` with its re-cuts, both filter variants, 5e-6 *
             max|plain| per field (phi, nw and dS exactly 0);
   K6 edges — K6 with x_edges against the plain walk and the sort rebin on
             that state a chunk later and on a seeded drift of it that
             puts particles across the periodic seam: bitwise;
   K2 polarization — K2 against the plain loop on
             cell_polarization.build(nx=100) (10,292 particles, 26 x 26
             doubly periodic cells, an elastic free wall, one species, the
             fsi pair style) after setup and after 200 steps, both filter
             variants, every field, dS and Q within 5e-6 * max|plain|: as
             run, and with the wall's S, the velocities, the densities and
             C (between 0 and 1 on the wall) seeded from numpy: one and two
             species, cutc = 1.2 h and 0.8 h, the advection correction on
             and off, ``ampl_damp`` 0.1 and 0, the modulus coupling on and
             off, and C up to 1.5 (a softened modulus below zero); AS, dS
             and every species' Q nonzero in each case;
   K6 periodic y — K6 against the plain walk and the sort rebin on that
             state and on a seeded drift of it across all four faces and
             corners of the box, the C, Q and S rows riding along: bitwise;
   K5 periodic — K5 against the plain walk and the sort rebin on the 2D
             vortex (taylor_green2d.build(N=1000): 336 x 336 doubly periodic
             cells of cap 14) after setup and 100 steps, with uniform x
             columns and with columns of widths 7/8 and 9/8 of a cell: as
             run, after a seeded drift across every face and corner and
             with positions a hair below and at the box's ends: bitwise;
   K7 edges periodic — K7 against the plain walk and the sort rebin on the
             balanced 3D blob (drift_blob.build(8, nz_cells=3): x_edges, x
             and z periodic) a chunk in and after a seeded drift across
             the x and z seams: bitwise;
   K8      — tools/torch_rotation_probe.py's ``run`` (the probe's entry
             point, its launches counted): mma bitwise slice, the three
             variants' times and, at f32 with TF32 off, the one PyTorch
             call of mma's g products, torch.matmul(x.expand(g, R, W), S);
             then each kernel against its plain version, bitwise, the plain
             versions' times and the bounds (slice, base: the bytes; mma:
             3 x R x W x 9 BLK x g multiply-adds at 495 TFLOP/s dense TF32);
9. main    — each path through its entry points with the launch counters
             reset first: lid_cavity.build(N=200) -> setup -> simulate(1000)
             (K1 once per step plus setup, K5 once per chunk plus setup),
             fsi.build(nx=60, tdamp_solid=500) -> setup -> simulate(1000)
             (K2 and K6 likewise) and lid_cavity3d.build(N=100) -> setup ->
             simulate(500) (1.19M particles; K3 and K7 likewise), no other
             kernel launched; no overflow or drift, particles conserved,
             fields finite, velocities and densities inside bounds set from
             the JAX package's own runs (the 3D cavity's at N=20, 200 steps,
             run on the card here too); main convection:
             natural_convection.build(N=200) -> setup -> simulate(1000) (K1
             1001 launches, K5 21, nothing else), 42,436 particles kept,
             0 <= C <= C0, walls and cylinder one half step from their
             Dirichlet values (C == max(value + Q dt/2, 0) to the bit),
             qdot > 0, and max|v|, qdot and the fluid's mean C inside bands
             around the JAX package's own N=200 run; main balance:
             Scene.balance(8).fix_balance(8).build() of the s=20 blob ->
             setup -> simulate(1000, balance_log=log) (K2 once per step plus
             setup, K6 once per chunk plus setup, nothing else), overflow
             and drift 0, 840,000 particles kept, at least two accepted
             re-cuts with distinct edges, each improving the metric that
             fired it, the final slab imbalance under 1.5, and x, v and rho
             tag by tag within BLOB_TOL of the uniform-grid run of the same
             blob; main preshift: lid_cavity.scene(N=1000,
             preshift_window=True) -> setup -> simulate(1000) (1,012,036
             particles in 112,896 cells of cap 14; K4 1001 launches, K5
             101, nothing else), the same run through K1 (K1 1001, K5 101)
             with the same inputs, the step-1000 states bitwise equal, every
             field, and K4 against the plain loop on that state at that
             shape (5e-6 * max|plain|, both filter variants); main
             mechanics: lid_cavity.scene(N=1000, pair_style="mechanics") ->
             setup -> simulate(1000) (K1's full body 1001, K5 101), the
             flagship's gate on the mean density and the extreme within 2%
             of the plain loop's own run of the same scene on the card
             (MECH_PLAIN_RHO1000), K1 against the plain loop on the
             step-1000 state (ddx nonzero) and K4 bitwise K1 there, then
             the same run with preshift_window=True (K4 1001, K5 101), its
             step-1000 state bitwise the K1 run's, every field; main
             mechanics vs JAX: N=50 and N=500 (where the lid corner's
             density extreme climbs as at N=1000), 1,000 steps each, the
             fluid's max|v|, kinetic energy, mean density and max|rho-1|
             inside 2% bands around the JAX package's own runs; main
             polarization:
             cell_polarization.build(nx=100) ->
             setup -> simulate(1000) at dt 1e-10 (K2 1001 launches, K6 11,
             nothing else), 10,292 particles kept, 0 <= C <= 1, the lower
             wall one half step from its Dirichlet value (C == max(1 + Q
             dt/2, 0) to the bit), species in the neighbours, the wall
             moving (released at step 2), and max|v|, the wall's max|v| and
             mean C and max|S| inside bands around the JAX package's own
             nx=100 run; main thermal: natural_convection.build(N=200) with
             thermal=True at the SI kB and e = 1e-6 -> setup ->
             simulate(1000) with a ThermoLogger(every=100, step dt press
             temp etotal) callback (K1's thermal instantiation 1001
             launches, K5 21, nothing else; a thermo row every 100 steps),
             the convection's gates with bands around the JAX package's own
             thermal-on N=200 run, and the gap to the thermal-off run; main
             thermal visible: lid_cavity.build(N=200) with e = 1 and kB =
             VISIBLE_KBE -> setup -> simulate(200), max|v| and the kinetic
             energy (all and fluid) inside 2% bands around the JAX package's
             own run of the same, the fluid's kinetic energy moved by more
             than 10% against the same run without the noise; main
             spanwise: lid_cavity3d.build_spanwise(N=100) -> setup ->
             simulate(500) (1,123,600 particles, y periodic; K3 501
             launches, K7 51, every rebin through K7, none sorted) with a
             callback every 250 steps that writes a Restart checkpoint and a
             legacy VTK frame (id, type, v and the rho and p computes),
             overflow and drift 0, max|v| <= 1.05, the fluid's density
             within 0.2% on the mean and 5% at the extreme, max|v_y| /
             max|v| under 1e-3 (SPAN_VY_BOUND; traced every 50 steps, the
             largest |v_y| located), each frame read back with read_vtk
             (every particle, finite), and K3 and K7 against their plain
             versions on the step-500 state;
             main spanwise resume: the step-250 checkpoint loaded on the
             card and run 250 steps equals the uninterrupted step-500 state
             bitwise, every field; main spanwise vs JAX: N=20, 200 steps,
             the fluid's max|v|, kinetic energy and mean density inside 2%
             bands around the JAX package's own run, and max|v_y| / max|v|
             within 10x the JAX package's own runs at N=12 and N=20 (step
             200) and N=40 (step 500); main fsi3d:
             fsi.build_spanwise(nx=60, tdamp_solid=500) -> setup ->
             simulate(1000) (170,632 particles; K3 1001 launches, K7 11,
             nothing else), overflow 0, the beam's tip displacement and
             max|S| > 0, and K3 against the plain loop on the step-1000
             state (the beam released, S live; 5e-6 * max|plain| per field,
             both filter variants), the plain loop run over pieces of
             target cells (PLAIN_PAIR_BLOCK); main tgv3d:
             taylor_green3d.build(N=100) -> setup -> simulate(1000)
             (1,000,000 particles; K3 1001, K7 201), the kinetic energy
             ratio E/E0 between 0.98 x the JAX package's N=20 value and
             1.01 x exp(-6 nu t), the mean density within 1e-2 (the
             O(Mach^2) of c0 = 10 U0), and on the step-1000 state K3
             against the plain loop with x jittered by up to 0.1 spacing
             (5e-6 * max|plain|) and, as run, K3 and the plain loop in f32
             each against the plain loop in f64 on the same inputs: K3
             within 5e-6 * max or F64_ERR_MULT x the plain f32 loop's own
             error, per field;
             main tgv2d: taylor_green2d.build(N=1000) -> setup ->
             simulate(1000) (1,000,000 particles; K2 1001, K5 201, nothing
             else), E/E0 between 0.98 x the JAX package's N=60 value and
             1.01 x exp(-4 nu t), the mean density within 1e-2, and on the
             step-1000 state K2 against the plain loop (its solid-free and
             periodic-y flags together) and K5 against the plain walk and
             the sort; main tgv2d vs JAX: N=60, 100 steps, E/E0, max|v| and
             mean density in 2% bands around the JAX package's own run;
             main blob3d: drift_blob.build(8, balance, inrun, nz_cells=3)
             -> setup -> simulate(500, balance_log=log) (1,324,800
             particles; K3 501, K7 101 = every in-place rebin, the re-cuts
             sort rebins, nothing else), overflow and drift 0, at least
             one accepted re-cut improving its metric, max|v| 2, K7 against
             the plain walk and the sort on the step-500 state, and x, v
             and rho tag by tag within BLOB3D_TOL of the uniform-grid run of the
             same blob; main blob3d vs JAX: s=1, 20 steps, max|v|, mean
             density and mean x in 1e-5 bands around the JAX package's run;
             main fsi3d vs JAX: nx=12, 20 steps released at step 10, max|v|,
             the fluid's density, the beam's max|v| and max|S| inside 2%
             bands around the JAX package's own run; main tgv3d vs JAX:
             N=20, 200 steps, E/E0, max|v| and mean density likewise; and
             the N=50
             cavity, the nx=24 FSI, the N=8 3D cavity
             (20 steps), the N=12 spanwise cavity (20 steps) and the s=1
             balanced blob (110 steps, its re-cut at step 100 included), the
             N=40 convection (x, v, rho and C) and
             the nx=40 polarization (x, v, rho, C and S) and the N=40
             visible-noise cavity (20 steps) on the card agree with the
             same runs through the plain path on the CPU;
   ssa     — the stochastic species, the four other integrators and the
             front end (``_ssa_paths``; each phase prints its seconds):
             main lmp ssa: ``examples/lid_cavity_ssa.lmp`` at N=200 through
             ``__main__.main`` for 1,000 steps (VTK frames every 500, a
             ``-log`` file): overflow and drift 0, particles conserved, the
             fluid's max|rho-1| <= 0.05 and |mean-1| <= 0.002, slots
             compacted, the molecule total within 5 binomial standard
             deviations of total0 e^-kt, K1 1,001, K5 101 and Qd-pass 1,001
             launches; K5 ssa: K5 against the plain walk and the sort rebin,
             bitwise, on that state (the Cd row in its i32 pack); speed lmp
             ssa: the script at N=1000 for 50 steps, particle-steps/s and
             the Qd pass's device ms a step beside K1's; main ssa golden:
             the SSA golden scenario (``tools/ssa_golden.py``'s text, 100
             steps, f32) through ``python -m sph_bvf_tpu_torch`` as a
             process of its own on the card against the port's CPU run:
             each total within 2 of CD0 (NXP/2) NXP, v exactly 0, Cd
             different on <= 1% of the particles, the 20 x-bin totals of
             card and CPU within 1% of total0/20 of each other; main
             integrators: the script at N=50 under ``ssa_tsdpd/bvf``,
             ``bvf/artificialStress`` and ``bvf/zhang`` (pass B on) through
             the card-vs-CPU comparison above, 20 steps, and
             ``ssa_tsdpd/stationary`` on the golden crystal (x and v
             bitwise unchanged); ensemble: 4 replicas of the golden
             scenario, 20 steps, replica 0 bitwise the single run with key
             [0, seed0], the replicas' Cd pairwise different, each total
             within 2;
10. speed  — particle-steps/s from the set-up state of the cavity at N=200
             and N=1000, of natural convection at N=200 and N=1000 (1,012,036
             particles, dt 2e-5; K1 with its species rows beside K1 on the
             same state without them), the same with the noise on (K1 with
             its thermal rows beside K1 without them), of FSI at nx=60 and nx=240, of the 3D
             cavity at N=40 and N=100, of cell polarization at nx=100 and
             nx=1000 (1,030,980 particles, dt 1e-11) and of the balanced and
             the uniform blob at s=10 and
             s=20 (500 steps of its main path), of the spanwise cavity at
             N=40 and N=100, of the 3D FSI beam at nx=30 and nx=60 (frozen;
             at nx=60 the plain pass A timed over pieces of target cells) and of the Taylor-Green
             vortex at N=20 and N=100, of the 2D vortex at N=1000 and of
             the balanced 3D blob at s=8, each chunk timed on the
             host clock and by CUDA events, the blob's chunks split into
             those with a re-cut, with a balance check and without; per
             call each kernel beside its plain version (K1 and K4 side by
             side on the flagship's N=200 set-up state, on the N=1000
             step-1000 states of main preshift and main mechanics, and K1
             on the seeded FSI state and on the crowded-cell grid after its
             10 steps; K4's bound is K1's; K2 elastic on the polarization
             at nx=1000 with its device time and its launches in the timed
             run), each rebin beside
             the sort rebin (and its host time), and the balanced blob's
             re-cut (host time of ``rebalance``, its sort rebin) (CUDA
             events after a warm-up), with each kernel's
             bound: the largest of its bytes over 3.35 TB/s, its f32
             operations on this run's data over 67 TFLOP/s and, with the
             noise, its 32-bit integer operations (the hash) over 16.7 TOP/s
             (64 INT32 lanes per SM x 132 SMs x 1.98 GHz), where the bytes
             are, at the run's occupancy, the valid row of every slot and
             the other input rows of the valid slots read once, and every
             output row of every slot written once;
11. profile — one chunk of the 3D cavity at N=40 and N=100 (and at N=40
             with the noise: K3's thermal rows), one of the cavity and one
             of the convection at N=200 and N=1000, without and with the
             noise (the same grids: K1 without and with its species and
             thermal rows), one of cell polarization at nx=100 with the
             noise (K2's thermal rows), one of cell
             polarization at nx=100 and nx=1000, one of the spanwise cavity
             at N=40 and N=100 (K3 and K7 periodic beside the walled cavity's
             K3 and K7), one of the 3D FSI beam at nx=60 (released) and one
             of the vortex at N=100 (K3's elastic and solid-free
             instantiations, K7 past cap 64), two of the s=20 blob,
             balanced and uniform, one of the 2D vortex at N=1000 (K2
             solid-free periodic, K5 periodic) and one of the balanced 3D
             blob at s=8 (K3 solid-free, K7 with x_edges on the periodic
             grid), under torch.profiler:
             device ops, device-to-host copies and device time per step,
             the busy share, and the
             pass-A and move kernels' device time per call; it fails if
             the profiler records no pass-A activity on the card; and K1's
             and K4's device time per call over 10 calls each on the states
             their speed rows time.

Every number is printed beside the card's name and power limit.  The
second-to-last line is ``{"kernels": [...]}`` (thirty-three entries: the
six kernels of PRs 1-3, then K2's solid-free and K5's, K6's and K7's
x_edges variants, K1 and K3 with species, K2 and K6 on the polarization
path, K1, K2 and K3 with their thermal rows, K3 and K7 with periodic axes,
K3 with the mechanics and fsi pair styles and without solids, K7 past cap
64, K4 on the flagship and on the mechanics cavity, K1's full body on the
mechanics cavity, K1 elastic/periodic (its launches those of its parity
and timing calls: no main path routes such a grid to it) and K1
solid-free as their own entries, then K5 periodic, K7 with x_edges on a
periodic grid and K8's three variants, with torch.matmul(x.expand(g, R,
W), S), mma's g products in one call, as the mma variant's library time),
the last
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result; so does a machine without a card, or a
directory without the package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

# the kernels' libraries (K4, pair_cuda.pass_a_2d_preshift, launches K1's;
# K6, rebin_cuda.rebin_move_2d_gated, K5's)
KERNELS = ("pass_a_2d", "pass_a_2d_rowloop", "pass_a_3d", "rebin_move_2d",
           "rebin_move_3d", "rotation_probe")
CAVITY_N = (200, 1000)  # parity/main/speed size, large speed size
FSI_NX = (60, 240)  # the reference's size, large speed size (~225k particles)
CAVITY3D_N = (40, 100)  # parity/speed size (97k particles), main/speed size (1.19M)
# the spanwise-periodic 3D cavity (lid_cavity3d.spanwise_scene: y periodic):
# parity/speed size (84,640 particles), main/speed size (1,123,600)
SPAN_N = (40, 100)
SPAN_PARTICLES = {40: 84_640, 100: 1_123_600}
# its main path: steps, and the cadence of its Restart checkpoints and VTK
# frames (the rho and p computes); the resumed run starts at the first
SPAN_STEPS, SPAN_EVERY = 500, 250
SPAN_TRACE = 50  # the cadence of its max|v_y| / max|v| trace
# the fully periodic box and the channel periodic in x and z of K3's and
# K7's periodic parity: lattice sites per periodic axis (91,125 in the box),
# and the cell margin that keeps a periodic cell under 3 spacings wide (45
# sites make 16 cells of 2.8; at most 27 particles a cell, cap 38; at the
# default 0.25 h they make 14 cells of 3.2, up to 64 particles a cell)
BOX_N, BOX_MARGIN = 45, 0.1
# the spanwise-periodic 3D FSI beam (fsi.spanwise_scene: the reference's
# beam in a channel extruded along z over 3 periodic cells; mechanics, XSPH,
# a free elastic beam on a 0.6x finer lattice, walls, the two sponges):
# parity/speed size (46,728 particles, cap 208), main/speed size, the
# reference's nx (170,632 particles, cap 296)
FSI3D_NX = (30, 60)
FSI3D_PARTICLES = {30: 46_728, 60: 170_632}
# its parity run: the beam's release and the steps before the parity phases
FSI3D_PARITY_RELEASE, FSI3D_PARITY_STEPS = 10, 20
# K3 with the fsi pair style on the 3D beam: the POLAR_CASES it runs
FSI3D_CASES = ("Ns=1 as the model", "Ns=2 cutc=0.8h advection",
               "Ns=1 ampl_damp=0", "Ns=1 no coupling", "Ns=1 C up to 1.5")
# the triply periodic 3D Taylor-Green vortex (taylor_green3d: solid-free,
# transport velocity, Re 100, dt 0.1 h / c0; cap 86): parity/speed size
# (8,000 particles), main/speed size (1,000,000)
TGV_N = (20, 100)
TGV_PARTICLES = {20: 8_000, 100: 1_000_000}
TGV_TRACE = 100  # the cadence of its main path's max|v| and max|vest| trace
BLOB_S = (10, 20)  # drifting blob scales: speed size (210k), main size (840k)
BLOB_N = {1: 2115, 10: 210_000, 20: 840_000}  # its particle counts
# natural convection: the reference's size (42,436 particles), large speed
# size (1,012,036).  dt: the reference's 1e-4 at N=200; at N=1000 that value
# scaled with the spacing, 2e-5, under the limits of h = 2.5e-3 there:
# viscous 0.125 h^2/eta = 9.3e-5, thermal 0.125 h^2/kappa = 6.5e-5, acoustic
# 0.25 h/c0 = 1.25e-4
CONV_N = (200, 1000)
CONV_DT = {200: 1e-4, 1000: 2e-5}
CONV_PARTICLES = 42_436
# cell polarization: the reference's size (10,292 particles), large speed
# size (1,030,980).  dt: the reference's 1e-10 at nx=100; at nx=1000 that
# value scaled with the spacing, 1e-11, under the limits of h = 1.5e-7
# there: acoustic 0.25 h/c0 = 9.3e-10 (the wall's c0 = 40.3), viscous
# 0.125 h^2 rho/eta = 2.8e-9
POLAR_NX = (100, 1000)
POLAR_DT = {100: 1e-10, 1000: 1e-11}
POLAR_PARTICLES = 10_292
SMALL = {"cavity": 50, "fsi": 24, "cavity3d": 8, "blob": 1,
         "convection": 40, "polarization": 40, "thermal": 40,
         "spanwise": 12}  # card vs CPU
# (the visible-noise cavity's CPU run is the script's longest, ~0.3-1 s a
# step on the host: 20 steps keep the whole script inside its time)
SMALL_STEPS = {"cavity": 20, "fsi": 20, "cavity3d": 20, "blob": 110,
               "convection": 20, "polarization": 20, "thermal": 20,
               "spanwise": 20, "integrators": 20}
MAIN_STEPS = {"cavity": 1000, "fsi": 1000, "cavity3d": 500, "blob": 1000,
              "convection": 1000, "polarization": 1000, "fsi3d": 1000,
              "tgv": 1000, "tgv2d": 1000, "blob3d": 500}
PARITY_STEPS = {"cavity": 100, "fsi": 300, "cavity3d": 100, "blob": 100,
                "convection": 200, "polarization": 200, "tgv": 100}
# K2 on the seeded polarization state: (label, ampl_damp, g0_chem_coupling,
# species_advection, species, cutc / h, C's upper bound on the wall)
POLAR_CASES = (
    ("Ns=1 as the model", 0.1, True, False, 1, 1.0, 1.0),
    ("Ns=2", 0.1, True, False, 2, 1.0, 1.0),
    ("Ns=2 cutc=1.2h", 0.1, True, False, 2, 1.2, 1.0),
    ("Ns=2 cutc=0.8h advection", 0.1, True, True, 2, 0.8, 1.0),
    ("Ns=1 advection", 0.1, True, True, 1, 1.0, 1.0),
    ("Ns=1 ampl_damp=0", 0.0, True, False, 1, 1.0, 1.0),
    ("Ns=1 no coupling", 0.1, False, False, 1, 1.0, 1.0),
    ("Ns=1 C up to 1.5", 0.1, True, False, 1, 1.0, 1.5),
)
# the species counts K1 is held to on the convection state beyond the run's
# own Ns=1 (2, and the kernels' limit), and the species supports cutc / h
SPECIES_NS = (2, 4)
SPECIES_CUTC = (1.2, 0.8)
# the x_edges checks of K5 and K7: steps through simulate on the edged
# grid and its rebin period (the 7/8-wide columns leave a drift budget of
# 1/16 of a lattice spacing, which the lid-driven fluid crosses in ~3 steps)
EDGE_STEPS, EDGE_REBIN = 10, 2
# the balanced blob's run against the uniform-grid run after MAIN_STEPS:
# the largest |difference| allowed per field, tag by tag, with x compared
# by minimum image along the periodic axis.  0 in f32: the blob's density
# stays exactly 1 and eta is 0, so every pair term is exactly 0 whatever
# the order of its sum, and both runs advance x by v * dt alike; any
# difference is a particle lost, doubled or mislabelled by a re-cut
BLOB_TOL = {"x": 0.0, "v": 0.0, "rho": 0.0}
FSI_RELEASE = {"parity": 100, "main": 500}  # tdamp_solid: the beam's release
# The JAX package's own run of the FSI main path (nx=60, tdamp_solid=500,
# f32, jnp path, on the CPU) at step 1000, and the band [lo, hi] x that
# value the card's run must land in.  Fluid next to the beam takes the
# beam's density through the Shepard filter, hence max|rho/1000-1| ~ 6.5.
FSI_JAX_STEP1000 = {
    "max|v|": (0.09333625435829163, 0.8, 1.25),
    "fluid max|rho/1000-1|": (6.510681629180908, 0.95, 1.05),
    "fluid mean rho": (1219.5228271484375, 0.99, 1.01),
    "beam max|v|": (0.025616399943828583, 0.5, 2.0),
    "beam max|S|": (2985.49462890625, 0.5, 2.0),
}
# The JAX package's own run of the 3D cavity at N=20 (f32, jnp path, on the
# CPU) at step 200, and the band [lo, hi] x that value the card's run of the
# same scene must land in.  The top fluid layer is z > 1 - 1/N.
CAVITY3D_JAX_N, CAVITY3D_JAX_STEPS = 20, 200
CAVITY3D_JAX_STEP200 = {
    "fluid max|v|": (0.06267453730106354, 0.98, 1.02),
    "fluid max|rho-1|": (0.0002028942108154297, 0.95, 1.05),
    "fluid mean rho": (1.0000001192092896, 0.99999, 1.00001),
    "top fluid mean v_x": (0.062198467552661896, 0.98, 1.02),
}
# The JAX package's own run of the convection main path (N=200, Ra=1e4, dt
# 1e-4, f32, jnp path, on the CPU: natural_convection.build -> setup ->
# simulate(1000), then max|v| over the valid particles, tools/nusselt.py's
# qdot of the cylinder and the mean of C over the fluid) at step 1000, and
# the band [lo, hi] x that value the card's run must land in.  max|v| is
# the start-up rearrangement of the lattice around the cylinder, one
# particle's value, hence its wider band.
CONV_JAX_STEP1000 = {
    "max|v|": (0.019408298656344414, 0.98, 1.02),
    "qdot": (0.14982187747955322, 0.98, 1.02),
    "fluid mean C": (0.02610955916120595, 0.98, 1.02),
}
# The JAX package's own run of the polarization main path (nx=100, dt 1e-10,
# f32, jnp path, on the CPU: cell_polarization.build -> setup ->
# simulate(1000), then max|v| over the valid particles, max|v| and the mean
# of C over the wall's particles and max|S|) at step 1000, and the band [lo,
# hi] x that value the card's run must land in.
POLAR_JAX_STEP1000 = {
    "max|v|": (3.888657331466675, 0.98, 1.02),
    "wall max|v|": (1.1732581853866577, 0.98, 1.02),
    "wall mean C": (0.12097806947825782, 0.98, 1.02),
    "max|S|": (47733.171875, 0.98, 1.02),
}
# The JAX package's own run of the convection main path with the SDPD noise
# on (thermal=True at the SI kB and the model's e = 1e-6; otherwise as
# CONV_JAX_STEP1000), and the bands the card's run must land in.
CONV_THERMAL_JAX_STEP1000 = {
    "max|v|": (0.019408080726861954, 0.98, 1.02),
    "qdot": (0.14982211589813232, 0.98, 1.02),
    "fluid mean C": (0.026109554825169978, 0.98, 1.02),
}
# The JAX package's own run of the spanwise-periodic cavity at N=20 (f32,
# jnp path, on the CPU: spanwise_scene(...).build() -> setup ->
# simulate(200)) at step 200, and the band [lo, hi] x that value the card's
# run of the same scene must land in.
SPAN_JAX_N, SPAN_JAX_STEPS = 20, 200
SPAN_JAX_STEP200 = {
    "fluid max|v|": (0.06267447769641876, 0.98, 1.02),
    "fluid ke": (9.765082213272918e-05, 0.98, 1.02),
    "fluid mean rho": (1.0000001458898187, 0.98, 1.02),
}
# max|v_y| / max|v| of the spanwise cavity: the flow is spanwise-invariant,
# so v_y is f32 rounding, which a wrong image across the y seam would break
# first.  The JAX package's own runs (f32, jnp path, on the CPU) at N and
# step: the card sums in another order, with FMA, and is held to 10x each
SPAN_JAX_VY = {12: (200, 7.314140475500608e-07),
               20: (200, 1.1972692846029531e-06),
               40: (500, 4.278628239262616e-06)}
# At N=100 no JAX run exists, and from step ~250 the downstream lid corner
# amplifies the rounding, past any extrapolation of the runs above (2.1e-4
# at step 500 on an NVIDIA H100 80GB HBM3 at 700 W, spread over y, not at
# the seam); a wrong image across the seam gives v_y of the order of v near
# the seam within a few steps.  The main path holds max|v_y| / max|v| under
# this bound
SPAN_VY_BOUND = 1e-3
# The JAX package's own run of the 3D FSI beam at nx=12 (the JAX package as
# of commit 259c089; tdamp_solid 10, rebin every 5, dt 1e-8, f32, jnp path,
# on the CPU: fsi.spanwise_scene(...).build() -> setup -> simulate(20)) at
# step 20, and the band [lo, hi] x that value the card's run of the same
# scene must land in
FSI3D_JAX_NX, FSI3D_JAX_STEPS, FSI3D_JAX_RELEASE, FSI3D_JAX_REBIN = 12, 20, 10, 5
FSI3D_JAX_STEP20 = {
    "max|v|": (0.03329138457775116, 0.98, 1.02),
    "fluid max|rho/1000-1|": (3.8262972831726074, 0.98, 1.02),
    "fluid mean rho": (1106.560502283385, 0.98, 1.02),
    "beam max|v|": (8.701364606622519e-08, 0.98, 1.02),
    "beam max|S|": (4.488551894610282e-06, 0.98, 1.02),
}
# The JAX package's own run of the Taylor-Green vortex at N=20 (the JAX
# package as of commit 259c089; f32, jnp path, on the CPU:
# taylor_green3d.scene(...).build(), the velocity set in numpy -> setup ->
# simulate(200), t = 1.5708) at step 200, and the band [lo, hi] x that
# value the card's run of the same scene must land in; beside it
# exp(-6 nu t) = 0.91006
TGV_JAX_N, TGV_JAX_STEPS = 20, 200
TGV_JAX_STEP200 = {
    "E/E0": (0.875730266896161, 0.98, 1.02),
    "max|v|": (0.8506942987442017, 0.98, 1.02),
    "mean rho": (1.0004214131981135, 0.98, 1.02),
}
THERMO_EVERY = 100  # the reference script's thermo cadence
# The JAX package's own run of the flagship cavity at N=200 with the noise
# made visible (e = 1 on the valid slots, kB = VISIBLE_KBE; f32, jnp path,
# on the CPU: lid_cavity.build -> setup -> simulate(VISIBLE_STEPS)): max|v|
# (the lid's), the kinetic energy, and the fluid's max|v| and kinetic
# energy, with the bands [lo, hi] x that value the card's run must land in
VISIBLE_STEPS = 200
CAVITY_VISIBLE_JAX_STEP200 = {
    "max|v|": (1.0, 0.98, 1.02),
    "ke": (0.016114081853033854, 0.98, 1.02),
    "fluid max|v|": (0.8929688930511475, 0.98, 1.02),
    "fluid ke": (0.005763092078582261, 0.98, 1.02),
}
SPEED_STEPS = {"cavity": {200: (200, 20), 1000: (50, 5)},
               "convection": {200: (200, 20), 1000: (50, 5)},
               "fsi": {60: (200, 10), 240: (50, 2)},
               "polarization": {100: (200, 10), 1000: (50, 3)},
               "cavity3d": {40: (100, 10), 100: (50, 3)},
               "spanwise": {40: (100, 10), 100: (50, 3)},
               "fsi3d": {30: (100, 10), 60: (100, 3)},
               "tgv": {20: (100, 10), 100: (50, 3)},
               "blob": {10: (500, 5), 20: (500, 3)},
               "tgv2d": {1000: (50, 3)},
               "blob3d": {8: (50, 3)}}
# timed runs of simulate per size, each from the same set-up state (the
# blob's: 500 steps of its main path without the build)
SPEED_REPEATS = {"cavity": 1, "fsi": 1, "cavity3d": 1, "blob": 1,
                 "convection": 1, "polarization": 1, "spanwise": 1,
                 "fsi3d": 1, "tgv": 1, "tgv2d": 1, "blob3d": 1}
# FSI rebin period: the model's 100 at nx=60; at nx=240 the cells are 4x
# smaller and the start-up pressure waves (|v| up to ~0.4) drift particles
# past the budget within 100 steps, so the run rebins every 20
FSI_REBIN = {60: 100, 240: 20}
TOL = 5e-6  # kernel vs plain, relative to the field's max
# Where the plain pass A's [cap, cap, NC] pair blocks would not fit on the
# card (the 3D FSI beam at nx=60, cap 296, and the vortex at N=100 in
# f64), it runs over pieces of target cells of at most this many pair
# slots each (cap^2 x cells; 128 MiB an f32 block)
PLAIN_PAIR_BLOCK = 1 << 25
# K3 in f32 against the plain loop in f64 on the vortex's step-1000 state:
# a field passes within TOL or within this multiple of the plain f32
# loop's own error against the same f64 reference
F64_ERR_MULT = 4.0
# the H100 SXM's published peaks: HBM bytes/s and f32 (non-tensor-core) flop/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# f32 operations a pass-A kernel spends on each valid candidate j of i's
# window (the distance and the support test) and on each pair inside the
# support (the transport-velocity pair body of csrc/pass_a_tv.cuh; K2's
# mechanics and elastic terms cost more, so for K2 it is a floor)
FLOPS_CANDIDATE, FLOPS_PAIR = 10, 120
# and on each pair inside the species support cutc: the flux's common factor
# and advection correction, then each species' term
FLOPS_SPECIES_PAIR, FLOPS_PER_SPECIES = 30, 9
# the thermal noise on each pair inside the support (csrc/pass_a_tv.cuh
# `add_thermal`, by dimension): the hash's 32-bit integer operations, with
# the words (seed, step) absorbed once per thread, then per pair the tags (2
# x 11), per salt its word (11) and two uniforms (2 x 21), 3 salts in 2D and
# 6 in 3D, plus min and max; and its f32 operations, ~60 per normal for
# Box-Muller (logf, sqrtf, cosf) and the prefactor and W dx
INT_OPS_THERMAL_PAIR = {2: 183, 3: 342}
FLOPS_THERMAL_PAIR = {2: 210, 3: 400}
# the H100 SXM's 32-bit integer issue rate: 64 INT32 lanes per SM x 132 SMs
# at 1.98 GHz, the clock of its 67 TFLOP/s f32 peak (128 lanes x 2)
PEAK_INT32 = 64 * 132 * 1.98e9
# the thermal noise: the step and PRNG key of the parity states (nonzero, so
# the kernels read them from the state), e where a model sets none (natural
# convection's own 1e-6), and the kB x e of the flagship cavity's visible
# run: at N=200 the noise's kinetic energy after 200 steps is about the lid-
# driven fluid's own (the JAX package's run at 1e-11 moved it by 1%; the
# parity phases' case (b) value, ~9e-8 there, kicks the fluid by ~1.2 a
# step, past what c0 = 10 carries)
THERMAL_STEP, THERMAL_KEY, THERMAL_E = 12345, (0xDEADBEEF, 0x12345), 1e-6
VISIBLE_KBE = 1e-9
# the grouped kernel's main paths: the flagship with preshift_window (K4) and
# the cavity under the mechanics pair style (K1's full body), at this N
# (1,012,036 particles in 112,896 cells of cap 14), this many steps, at
# lid_cavity's dt past N=200
GROUPED_N, GROUPED_STEPS = 1000, 1000
GROUPED_DT = 5e-3 / GROUPED_N
# The fluid's max|rho-1| of the mechanics cavity at GROUPED_N after
# GROUPED_STEPS with pass A through the plain PyTorch loop on the card
# (tools/torch_cavity_rho_trace.py 1000 1000 mechanics plain, on an NVIDIA
# H100 80GB HBM3 at 700 W; K1 and K2 read 0.07230198 there), and the band
# [lo, hi] x that value the card's run must land in.  The flagship's bound
# of 0.05, set from the JAX package's N=200 run, does not hold here: the
# lid's upper-left corner drives the extreme up through the run, from 0.050
# at step 200 to 0.072 at step 1000 (the flagship at N=1000: 0.045).  The
# JAX package's own run at N=500 (MECH_JAX) is the witness that this climb
# is the scene's, not the port's
MECH_PLAIN_RHO1000 = (0.07230180501937866, 0.98, 1.02)
# The JAX package's own runs of the mechanics cavity (f32, jnp path, on the
# CPU: tests/jax_mechanics_cavity_run.py N 1000 100, i.e.
# lid_cavity.scene(..., pair_style="mechanics").build() -> setup ->
# simulate(MECH_JAX_STEPS) at lid_cavity's dt) at N=50 and at N=500, where
# the corner's extreme climbs as at GROUPED_N (0.0199 at step 100, 0.0406
# at step 1000): per N its dt and, per value, the value at the last step
# and the band [lo, hi] x it the card's run of the same scene must land in
MECH_JAX_STEPS = 1000
MECH_JAX = {
    50: (1e-4, {
        "fluid max|v|": (0.6236324310302734, 0.98, 1.02),
        "fluid ke": (0.005463925098311307, 0.98, 1.02),
        "fluid mean rho": (0.9980279005527496, 0.98, 1.02),
        "fluid max|rho-1|": (0.009687364101409912, 0.98, 1.02),
    }),
    500: (1e-5, {
        "fluid max|v|": (0.8683755993843079, 0.98, 1.02),
        "fluid ke": (0.0027457284159890733, 0.98, 1.02),
        "fluid mean rho": (0.9996966768286228, 0.98, 1.02),
        "fluid max|rho-1|": (0.04062420129776001, 0.98, 1.02),
    }),
}


# the doubly periodic 2D Taylor-Green vortex (taylor_green2d: solid-free,
# transport velocity, Re 100, cells under 3 spacings: cap 14, so K2 and K5
# on both periodic axes): the main path's N (1,000,000 particles in 336 x
# 336 cells), and the steps of K5's parity state
TGV2D_N, TGV2D_PARTICLES, TGV2D_PARITY_STEPS = 1000, 1_000_000, 100
# The JAX package's own run of the vortex at N=60 (f32, jnp path, on the
# CPU: taylor_green2d.scene(...).build(), the velocity set in numpy -> setup
# -> simulate(100), t = 0.2618; exp(-4 nu t) = 0.98958 there) and the band
# [lo, hi] x that value the card's run of the same scene must land in
TGV2D_JAX_N, TGV2D_JAX_STEPS = 60, 100
TGV2D_JAX = {
    "E/E0": (0.9777353014504775, 0.98, 1.02),
    "max|v|": (1.0016767978668213, 0.98, 1.02),
    "mean rho": (1.0020084295007918, 0.98, 1.02),
}
# the 3D drifting blob (drift_blob.scene(..., nz_cells=3): x and z periodic,
# x_edges from Scene.balance, re-cut by fix_balance; K3 solid-free, K7 with
# x_edges on the periodic grid): the main path's s (1,324,800 particles)
BLOB3D_S, BLOB3D_NZ, BLOB3D_PARTICLES = 8, 3, 1_324_800
# the balanced 3D run against the uniform one, tag by tag, as BLOB_TOL: every
# pair term is exactly 0 here too, whatever the order of the 27-cell sums
BLOB3D_TOL = dict(BLOB_TOL)
# The JAX package's own run of the 3D blob at s=1 (f32, jnp path, on the CPU:
# drift_blob.scene(1, True, True, 3, ...).build() -> setup -> simulate(20))
# and the band [lo, hi] x that value the card's run of the same scene must
# land in (pure advection: the speed stays 2 and the density 1)
BLOB3D_JAX_S, BLOB3D_JAX_STEPS = 1, 20
BLOB3D_JAX = {
    "max|v|": (2.0, 0.99999, 1.00001),
    "mean rho": (1.0, 0.99999, 1.00001),
    "mean x": (0.7194285499789412, 0.99999, 1.00001),
}
# K8, the window-rotation probe (tools/torch_rotation_probe.py): the calls
# per timed run of its entry point, and the H100 SXM's dense TF32
# tensor-core rate, the mma variant's bound
PROBE_REPEATS = 50
PEAK_TF32 = 495e12

# the stochastic species, the four integrators and the LAMMPS-script front
# end: the lid-driven cavity with one SSA species
# (examples/lid_cavity_ssa.lmp, the flagship's particles) at its main size
# and its speed size, each size's dt (the flagship's) and steps; the
# integrator paths' size and steps (card_vs_cpu's)
LMP_SSA_SCRIPT = Path(__file__).resolve().parent / "examples" / "lid_cavity_ssa.lmp"
LMP_SSA_N = (200, 1000)
LMP_SSA_DT = {200: 1e-4, 1000: 5e-6}
LMP_SSA_STEPS = {200: 1000, 1000: 50}
LMP_SSA_EVERY = 500  # its VTK frames
INTEG_N = 50
INTEG_STEPS = SMALL_STEPS["integrators"]
INTEG_FIXES = ("ssa_tsdpd/bvf", "ssa_tsdpd/bvf/artificialStress",
               "ssa_tsdpd/bvf/zhang")
# the SSA golden scenario of tools/ssa_golden.py (a fixed-solid crystal of
# NXP x NXP particles, CD0 molecules on its left half), its steps on the
# card and on the CPU, its x bins; the ensemble's replicas, steps and seed
GOLDEN_NXP, GOLDEN_CD0, GOLDEN_STEPS, GOLDEN_BINS = 40, 50, 100, 20
ENSEMBLE_R, ENSEMBLE_STEPS, ENSEMBLE_SEED0 = 4, 20, 5


def _k4_bitwise(torch, pair, pair_cuda, state, params, geom, cfg0, tag):
    """K4 against K1 on one state, both filter variants: every pass-A
    accumulator bitwise equal."""
    noise = pair.noise_inputs(state)
    for filt in (True, False):
        cfg = dataclasses.replace(cfg0, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        k1 = pair_cuda.pass_a_2d(pf, params, geom, cfg, noise)
        k4 = pair_cuda.pass_a_2d_preshift(pf, params, geom, cfg, noise)
        for name in pair.PASS_A_ACCS:
            if not torch.equal(k1[name], k4[name]):
                diff = float((k1[name] - k4[name]).abs().max())
                raise AssertionError(f"{tag} {name} (filter={filt}): K4 != K1, "
                                     f"max|diff| {diff!r}")


def _grouped_parity(torch, pair, pair_cuda, state, params, geom, cfg, names,
                    tag, piece=None):
    """K1 against the plain loop (``_pass_a_parity``), then K4 bitwise K1
    on the same state.  Returns ``_pass_a_parity``'s result."""
    out = _pass_a_parity(torch, pair, pair_cuda.pass_a_2d, state, params, geom,
                         cfg, names, tag, piece)
    _k4_bitwise(torch, pair, pair_cuda, state, params, geom, cfg, tag)
    return out


def _crowded_grid(torch, S, pair, dev):
    """tests/test_pair_pallas.py's crowded-cell grid
    (``test_grouped_crowded_cell``), rebuilt from numpy: a lattice-aligned
    solid-free grid (32 x 16 cells of cap 12, base_occ 4, one particle per
    unit site) with 7 more particles in cell (1, 1), seeded velocities,
    one type, transport velocity without solids.  Returns (state, params,
    geom, cfg)."""
    import numpy as np

    from sph_bvf_tpu_torch.ops.eos import tait_b

    geom = S.Geometry.build(dim=2, lo=(0.0, 0.0, 0.0), hi=(64.0, 32.0, 1.0),
                            cutoff=1.0, cap=12, quantum=1.0)
    if not (geom.base_occ == 4 and geom.ncells == (32, 16, 1)):
        raise AssertionError(f"crowded grid: {geom.ncells}, base_occ "
                             f"{geom.base_occ}")
    gx, gy = np.meshgrid(np.arange(64) + 0.5, np.arange(32) + 0.5)
    x = np.stack([gx.ravel(), gy.ravel()], axis=1)
    rng = np.random.default_rng(11)
    extra = np.stack([2.05 + 1.9 * rng.random(7), 2.05 + 1.9 * rng.random(7)],
                     axis=1)
    x = np.concatenate([x, extra])
    state = S.state_from_particles(geom, x, np.zeros(len(x), np.int64),
                                   dtype=torch.float32, device=dev)
    n = len(x)
    v = rng.standard_normal((n, 3)).astype(np.float32) * 0.01
    v[:, 2] = 0.0
    state = S.scatter_by_tag(state, v=v, vest=v,
                             rho=np.full(n, 1.0, np.float32),
                             rhoI=np.full(n, 1.0, np.float32))
    state = dataclasses.replace(
        state, rho=torch.where(state.valid, state.rho, 1.0),
        rhoI=torch.where(state.valid, state.rhoI, 1.0),
        dt=torch.tensor(1e-4, dtype=torch.float32, device=dev))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    one = t(np.ones(1))
    params = S.Params(
        mass=one, rho0=one, c0=10.0 * one, B=t(tait_b(10.0 * np.ones(1),
                                                      np.ones(1))),
        G0=0.0 * one, cut=t(np.ones((1, 1))), cutc=t(np.ones((1, 1))),
        visc=t(0.1 * np.ones((1, 1))), kappa=t(np.zeros((1, 1, 0))),
        kappa_ssa=t(np.zeros((1, 1, 0))))
    cfg = pair.PairConfig.transport_velocity(
        dim=2, solids_present=False, elastic_present=False,
        free_solids_present=False, weighted_solid=False)
    return state, params, geom, cfg


def _kernel_device_ms(torch, fn, match, iters):
    """Device ms per call of the kernels whose name holds ``match`` over
    ``iters`` calls of ``fn`` under torch.profiler (after a warm-up call),
    and their count.  A window whose device records the profiler lost
    (it has dropped a whole window's on the H100 host, and part of one:
    PERF.md) is profiled again, at most twice."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.key]
        count = sum(e.count for e in hits)
        if count:
            return (sum(e.self_device_time_total for e in hits) / count / 1e3,
                    count)
    raise AssertionError(f"torch.profiler recorded no {match} kernel in 3 "
                         f"windows of {iters} calls")


def _nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _packed(S, rebin_cuda, state, geom, drop):
    """The f32 and i32 packs the rebin hands its kernel (dropped leaves
    left out), and the f32 row of x."""
    fields = {k: v for k, v in S.particle_fields(state).items()
              if k not in drop}
    PF, PI, fmeta, _ = rebin_cuda._pack_fields(fields, geom.cap,
                                               geom.ncells_total)
    return PF, PI, rebin_cuda._x_row(fmeta)


def _pass_a_parity(torch, pair, kernel, state, params, geom, cfg0, names, tag,
                   piece=None):
    """Kernel vs plain pass A on one state, both filter variants: every
    field of ``names`` within TOL of its max (with the thermal noise, on
    the state's own dt, step and key; the plain loop over ``piece`` target
    cells at a time, all at once by default).  Returns ({field: rel err},
    max abs err, the plain outputs of the filter variant)."""
    errs, worst, refs = {}, 0.0, None
    noise = pair.noise_inputs(state)
    for filt in (True, False):
        cfg = dataclasses.replace(cfg0, density_filter_accs=filt)
        pf = pair._per_particle(state, params, cfg)
        ref = pair._pass_a_plain(pf, params, geom, cfg, noise,
                                 cells_per_piece=piece)
        got = kernel(pf, params, geom, cfg, noise)
        torch.cuda.synchronize()
        for name in names + (("rhoAux1", "rhoAux2") if filt else ()):
            err = float((got[name] - ref[name]).abs().max())
            scale = max(float(ref[name].abs().max()), 1e-30)
            errs[f"{name}{'' if filt else '/nf'}"] = err / scale
            worst = max(worst, err)
            if not err <= TOL * scale:
                raise AssertionError(
                    f"{tag} {name} (filter={filt}): max|diff| {err!r} > "
                    f"{TOL} * max|ref| {scale!r}")
        if not filt and float(got["rhoAux1"].abs().max()) != 0.0:
            raise AssertionError(f"{tag} without the filter rows wrote rhoAux1")
        if refs is None:
            refs = ref
    return errs, worst, refs


def _f64_parity(torch, pair, kernel, state, params, geom, cfg, names, tag,
                piece):
    """The kernel and the plain pass A in f32, each against the plain pass
    A in f64 on the same f32 inputs (the per-particle fields and the
    params widened), over ``piece`` target cells at a time: every field of
    ``names``, relative to its f64 max, passes within TOL or within
    F64_ERR_MULT x the plain f32 loop's own error.  Returns {field:
    (kernel's error, the plain f32 loop's)}."""
    pf = pair._per_particle(state, params, cfg)
    got = kernel(pf, params, geom, cfg)
    p32 = pair._pass_a_plain(pf, params, geom, cfg, cells_per_piece=piece)

    def wide(t):
        return t.double() if torch.is_tensor(t) and t.is_floating_point() else t
    params64 = dataclasses.replace(params, **{
        f.name: wide(getattr(params, f.name))
        for f in dataclasses.fields(params)})
    ref = pair._pass_a_plain({k: wide(v) for k, v in pf.items()}, params64,
                             geom, cfg, cells_per_piece=piece)
    torch.cuda.synchronize()
    errs = {}
    for name in names + (("rhoAux1", "rhoAux2")
                         if cfg.density_filter_accs else ()):
        scale = max(float(ref[name].abs().max()), 1e-300)
        ek = float((got[name].double() - ref[name]).abs().max()) / scale
        ep = float((p32[name].double() - ref[name]).abs().max()) / scale
        errs[name] = (ek, ep)
        if not ek <= max(TOL, F64_ERR_MULT * ep):
            raise AssertionError(
                f"{tag} {name}: the kernel's error against the f64 plain loop "
                f"{ek!r} of max exceeds {TOL} and {F64_ERR_MULT} x the f32 "
                f"plain loop's {ep!r}")
    return errs


def _seed_species(torch, state, params, ns, seed, cutc_scale=1.0):
    """(state, params) with ``ns`` continuum species: the species the state
    has are kept, the others' C drawn uniformly from [0, 1) on the valid
    slots, kappa [T, T, ns] symmetric with a distinct value per type pair
    and species (0.006..0.018, the convection's 0.012 in the middle), the
    species support cutc = ``cutc_scale`` x h; all from numpy's ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev, fdt = state.x.device, state.x.dtype
    T, have = params.ntypes, min(params.n_sdpd, ns)
    C = torch.as_tensor(rng.uniform(0.0, 1.0, (ns,) + tuple(state.valid.shape)),
                        dtype=fdt, device=dev) * state.valid
    C[:have] = state.C[:have]
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    kappa = 0.012 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    return (dataclasses.replace(state, C=C, Q=torch.zeros_like(C)),
            dataclasses.replace(
                params, cutc=cutc_scale * params.cut,
                kappa=torch.as_tensor(kappa, dtype=fdt, device=dev)))


def _seed_polar(torch, state, params, ns, seed, cutc_scale=1.0, c_hi=1.0):
    """(state, params) of a polarization state with every pair term live: a
    seeded symmetric S on the wall (the artificial-stress tensor tensile
    somewhere), seeded noise on v, vest and rho, ``ns`` species with C
    uniform in [0, ``c_hi``) on the wall and a tenth of that elsewhere,
    kappa [T, T, ns] symmetric with a distinct value per type pair and
    species (0.5e-5..1.5e-5, the wall's 1e-5 in the middle) and the species
    support cutc = ``cutc_scale`` x h; all from numpy's ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev, fdt = state.x.device, state.x.dtype
    t = lambda a: torch.as_tensor(a, dtype=fdt, device=dev)
    shape = tuple(state.valid.shape)
    valid = state.valid
    wall = valid & (state.solid_tag == 1)
    S = rng.normal(0.0, 2e3, (3, 3) + shape)
    v = state.v + t(rng.normal(0, 0.5, (3,) + shape)) * valid
    vest = v + t(rng.normal(0, 0.1, (3,) + shape)) * valid
    v[2] = 0.0
    vest[2] = 0.0
    C = t(rng.uniform(0.0, c_hi, (ns,) + shape))
    C = torch.where(wall, C, 0.1 * C) * valid
    T = params.ntypes
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    kappa = 1e-5 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    one = torch.ones((), dtype=fdt, device=dev)
    return (dataclasses.replace(
                state, S=torch.where(wall, t(S + np.swapaxes(S, 0, 1)), 0.0 * one),
                v=v, vest=vest, C=C, Q=torch.zeros_like(C),
                rho=torch.where(valid, state.rho * t(rng.uniform(0.99, 1.01, shape)),
                                one)),
            dataclasses.replace(params, cutc=cutc_scale * params.cut,
                                kappa=t(kappa)))


def _seed_beam_S(torch, state, seed):
    """``state`` with a symmetric S drawn from N(0, 1e3) (numpy's
    ``seed``) on the free solids (the beam), so that AS is tensile on some
    particles and every elastic term of pass A is live."""
    import numpy as np

    beam = state.valid & (state.solid_tag == 1) & (state.fixed_tag == 0)
    S = np.random.default_rng(seed).normal(0.0, 1e3, tuple(state.S.shape))
    S = torch.as_tensor(S + np.swapaxes(S, 0, 1), dtype=state.S.dtype,
                        device=state.x.device)
    return dataclasses.replace(state, S=torch.where(beam, S, state.S))


def _seed_beam(torch, state, params, ns, seed, cutc_scale=1.0, c_hi=1.0):
    """(state, params) of the 3D FSI beam with every pair term of the fsi
    pair style live, as ``_seed_polar`` for the polarization's wall: a
    seeded symmetric S on the beam, seeded noise on v (N(0, 0.01)), vest (v
    + N(0, 0.002)) and rho (x U(0.99, 1.01)), ``ns`` species with C
    uniform in [0, ``c_hi``) on the beam and a tenth of that elsewhere,
    kappa [T, T, ns] symmetric with a distinct value per type pair and
    species (0.5e-5..1.5e-5) and the species support cutc = ``cutc_scale``
    x h; all from numpy's ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dev, fdt = state.x.device, state.x.dtype
    t = lambda a: torch.as_tensor(a, dtype=fdt, device=dev)
    shape = tuple(state.valid.shape)
    valid = state.valid
    beam = valid & (state.solid_tag == 1) & (state.fixed_tag == 0)
    v = state.v + t(rng.normal(0, 0.01, (3,) + shape)) * valid
    vest = v + t(rng.normal(0, 0.002, (3,) + shape)) * valid
    C = t(rng.uniform(0.0, c_hi, (ns,) + shape))
    C = torch.where(beam, C, 0.1 * C) * valid
    T = params.ntypes
    kappa = rng.uniform(0.5, 1.5, (T, T, ns))
    kappa = 1e-5 * 0.5 * (kappa + kappa.transpose(1, 0, 2))
    state = _seed_beam_S(torch, state, seed)
    return (dataclasses.replace(
                state, v=v, vest=vest, C=C, Q=torch.zeros_like(C),
                rho=torch.where(valid, state.rho * t(rng.uniform(0.99, 1.01, shape)),
                                state.rho)),
            dataclasses.replace(params, cutc=cutc_scale * params.cut,
                                kappa=t(kappa)))


def _corner_drift(torch, state, geom, seed):
    """``state`` with every valid particle moved by a seeded step of up to
    0.9 cells per axis (within one ring of the cell its slot belongs to),
    outward along both axes in the four corner cells, so that particles
    cross every face and every corner of a doubly periodic box; positions
    beyond the box stay unwrapped, as between two rebins.  Returns the state
    and the count of particles beyond each corner."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    nx, ny = geom.ncells[:2]
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    cx, cy = c // ny, c % ny
    corner = ((cx == 0) | (cx == nx - 1)) & ((cy == 0) | (cy == ny - 1))
    d[0] = np.where(corner, np.where(cx == 0, -1.0, 1.0) * np.abs(d[0]), d[0])
    d[1] = np.where(corner, np.where(cy == 0, -1.0, 1.0) * np.abs(d[1]), d[1])
    d[2] = 0.0
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    out = {"x-": x[0] < geom.lo[0], "x+": x[0] >= geom.hi[0],
           "y-": x[1] < geom.lo[1], "y+": x[1] >= geom.hi[1]}
    across = {a + b: int((valid & out[a] & out[b]).sum())
              for a in ("x-", "x+") for b in ("y-", "y+")}
    across.update({a: int((valid & m).sum()) for a, m in out.items()})
    return dataclasses.replace(
        state, x=torch.as_tensor(x, device=state.x.device)), across


def _seam_drift(torch, state, geom, seed):
    """The 3D counterpart of ``_corner_drift``: every valid particle moved
    by a seeded step of up to 0.9 cells per axis, outward along every
    periodic axis in the corner cells (those at an end of each periodic
    axis), so that particles cross every periodic face and corner;
    positions beyond the box stay unwrapped.  Returns the state and the
    count of particles beyond each periodic face and beyond a corner."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    coord = [(c // geom.strides[ax]) % geom.ncells[ax] for ax in range(3)]
    axes = [ax for ax in range(3) if geom.periodic[ax]]
    corner = np.ones(valid.shape, bool)
    for ax in axes:
        corner &= (coord[ax] == 0) | (coord[ax] == geom.ncells[ax] - 1)
    for ax in axes:
        d[ax] = np.where(corner, np.where(coord[ax] == 0, -1.0, 1.0)
                         * np.abs(d[ax]), d[ax])
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    across, past = {}, valid.copy()
    for ax in axes:
        lo, hi = x[ax] < geom.lo[ax], x[ax] >= geom.hi[ax]
        across["xyz"[ax] + "-"] = int((valid & lo).sum())
        across["xyz"[ax] + "+"] = int((valid & hi).sum())
        past &= lo | hi
    across["corner"] = int(past.sum())
    if min(across.values()) == 0:
        raise AssertionError(f"the seam drift crossed no particle somewhere: {across}")
    return dataclasses.replace(
        state, x=torch.as_tensor(x, device=state.x.device)), across


def _edges_seam_drift(torch, state, geom, seed):
    """``state`` on a 3D x_edges grid periodic in x and z with every valid
    particle moved by a seeded step of up to 0.9 of the narrowest cell per
    axis, outward along z in the first and last z layer, and a seeded half
    of the first and last x column's particles put past the x seam by up to
    0.9 of the narrowest column (a wide end column's particles may sit far
    from its edge); positions beyond the box stay unwrapped.  Returns the
    state and the count of particles beyond each face."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    nx, ny, nz = geom.ncells
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    cx, cz = c // (ny * nz), c % nz
    d[2] = np.where(cz == 0, -np.abs(d[2]),
                    np.where(cz == nz - 1, np.abs(d[2]), d[2]))
    x = (x + np.where(valid, d, 0.0)).astype(np.float32)
    past = np.abs(d[0]) * (rng.uniform(size=valid.shape) < 0.5)
    x[0] = np.where(cx == 0, np.where(past > 0, geom.lo[0] - past, x[0]),
                    np.where((cx == nx - 1) & (past > 0), geom.hi[0] + past,
                             x[0])).astype(np.float32)
    across = {f"{'xyz'[ax]}{sign}": int((valid & beyond).sum())
              for ax in (0, 2)
              for sign, beyond in (("-", x[ax] < geom.lo[ax]),
                                   ("+", x[ax] >= geom.hi[ax]))}
    if min(across.values()) == 0:
        raise AssertionError(f"the seam drift crossed no particle somewhere: {across}")
    return dataclasses.replace(
        state, x=torch.as_tensor(x, device=state.x.device)), across


def _seam_hairs(torch, state, geom, seed):
    """``state`` on a doubly periodic 2D grid with a seeded share of the
    particles of the first and last cell along x and along y put a hair
    below the box's low end (-1e-7, -1e-30), at its high end or a hair below
    or above it, in f32: the positions whose wrap and bin the seam
    decides."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy().astype(np.float32)
    valid = state.valid.cpu().numpy()
    c = np.broadcast_to(np.arange(geom.ncells_total), valid.shape)
    for ax, ci in ((0, c // geom.ncells[1]), (1, c % geom.ncells[1])):
        L = np.float32(geom.hi[ax])
        hairs = np.array([-1e-7, -1e-30, np.nextafter(L, np.float32(0)), L,
                          L + np.float32(1e-6)], np.float32)
        edge = (ci == 0) | (ci == geom.ncells[ax] - 1)
        sel = valid & edge & (rng.uniform(size=valid.shape) < 0.3)
        x[ax] = np.where(sel, hairs[rng.integers(0, len(hairs), valid.shape)],
                         x[ax])
    return dataclasses.replace(
        state, x=torch.as_tensor(x, device=state.x.device))


def _load_tool(name):
    """``tools/<name>.py`` of this checkout as a module."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jitter(torch, state, spacing, seed, stir=False):
    """``state`` with every valid position moved by a seeded step of up to
    a tenth of the lattice ``spacing`` per axis (numpy); with ``stir``, also
    v from N(0, 0.05), vest from v + N(0, 0.01) and rho from U(0.99, 1.01)
    on the valid slots, so that every pair term is live in a fluid at rest."""
    import numpy as np

    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=state.x.dtype, device=state.x.device)
    valid = state.valid
    d = rng.uniform(-0.1, 0.1, tuple(state.x.shape)) * spacing
    state = dataclasses.replace(state, x=state.x + t(d) * valid)
    if stir:
        v = t(rng.normal(0.0, 0.05, tuple(state.v.shape))) * valid
        state = dataclasses.replace(
            state, v=v, vest=v + t(rng.normal(0.0, 0.01, tuple(v.shape))) * valid,
            rho=torch.where(valid, t(rng.uniform(0.99, 1.01, tuple(valid.shape))),
                            state.rho))
    return state


def _periodic_grid(Scene, Region, N, shape, thermal=False):
    """An unbuilt scene for K3's and K7's periodic parity: ``shape`` "box",
    a fully periodic unit box of fluid around a fixed solid sphere of
    radius 0.25 at its centre, or "channel", a channel periodic in x and z
    between fixed walls of three layers normal to y; N lattice sites per
    periodic axis, the cell margin BOX_MARGIN (cells of at most three
    spacings), the transport-velocity pair with h = 2.5 spacings, e = 1,
    and the thermal noise on with ``thermal``."""
    import numpy as np

    d = 1.0 / N
    channel = shape == "channel"
    sc = Scene(dim=3, boundary=("p", "f", "p") if channel else ("p", "p", "p"))
    sc.margin_frac = BOX_MARGIN
    if channel:
        sc.create_box(2, Region.block(0.0, 1.0, -3 * d, 1.0 + 3 * d, 0.0, 1.0))
        solid = ~Region.block(-np.inf, np.inf, 0.0, 1.0, -np.inf, np.inf)
    else:
        sc.create_box(2, Region.block(0.0, 1.0, 0.0, 1.0, 0.0, 1.0))
        solid = Region.sphere(0.5, 0.5, 0.5, 0.25)
    sc.lattice("sc", d, origin=(0.5, 0.5, 0.5))
    sc.create_atoms(1, ~solid)
    sc.create_atoms(2, solid)
    sc.group_region("solid", solid)
    sc.mass(1, d**3).mass(2, d**3)
    sc.set("all", rho=1.0, e=1.0)
    sc.set("solid", solid_tag=1, fixed=True)
    sc.pair_style("transport_velocity", thermal=thermal)
    for (i, j) in ((1, 1), (1, 2), (2, 2)):
        sc.pair_coeff(i, j, 1.0, 10.0, 0.01, 2.5 * d, 2.5 * d, 0.0)
    sc.integrator("transport_velocity")
    sc.timestep(1e-4)
    return sc


def _write_frame(S, computes, vtk, path, state, geom):
    """A legacy ASCII VTK frame of the valid particles by tag: id, type,
    the velocity and the rho and p per-atom computes (DumpVTK's names).
    Returns the particle count written."""
    out = S.gather_particles(state, geom, ("x", "v", "ptype"))
    pd = {"id": out["tag"], "type": out["ptype"] + 1,
          "vx": out["v"][:, 0], "vy": out["v"][:, 1], "vz": out["v"][:, 2],
          "c_rhoatom": computes.gather_compute(state, geom, "rho"),
          "c_patom": computes.gather_compute(state, geom, "p")}
    vtk.write_vtk(str(path), out["x"], pd)
    return out["x"].shape[0]


def _species_parity(torch, pair, kernel, cases, geom, cfg, tag):
    """Kernel vs plain pass A with species on each of ``cases`` (label,
    state, params): every field and Q within TOL, both filter variants, and
    every species' Q nonzero.  Returns ({label: Q's rel err with / without
    the filter rows}, max abs err)."""
    names = ("f", "drho", "num_den", "phi", "nw", "ddv", "de", "Q")
    errs, worst = {}, 0.0
    for label, state, params in cases:
        err, err_abs, ref = _pass_a_parity(torch, pair, kernel, state, params,
                                           geom, cfg, names, f"{tag} {label}")
        q_least = float(ref["Q"].abs().amax(dim=(1, 2)).min())
        if not q_least > 0.0:
            raise AssertionError(f"{tag} {label} is vacuous: a species' "
                                 f"max|Q| is {q_least!r}")
        errs[label] = (err["Q"], err["Q/nf"], max(err.values()))
        worst = max(worst, err_abs)
    return errs, worst


def _noise_on(spec):
    """``spec`` with the pair style's SDPD thermal noise on."""
    return dataclasses.replace(spec, pair=dataclasses.replace(spec.pair,
                                                              thermal=True))


def _with_noise(built):
    """A model's (state, params, spec, scene) with the noise on."""
    state, params, spec, scene = built
    return state, params, _noise_on(spec), scene


def _visible_cavity(N, device, thermal=True):
    """The flagship cavity with e = 1 on its valid slots and kB =
    VISIBLE_KBE, with the noise on (or, ``thermal=False``, off)."""
    import torch

    from sph_bvf_tpu_torch.models import lid_cavity

    state, params, spec, scene = lid_cavity.build(N=N, device=device)
    state = dataclasses.replace(state, e=torch.where(state.valid, 1.0, 0.0).to(
        state.e.dtype))
    spec = dataclasses.replace(spec, pair=dataclasses.replace(
        spec.pair, thermal=thermal))
    return state, dataclasses.replace(params, boltz=VISIBLE_KBE), spec, scene


def _cavity_energy(torch, state, params):
    """max|v| and the kinetic energy over the valid particles and over the
    fluid."""
    valid = state.valid
    fluid = valid & (state.solid_tag == 0)
    vsq = (state.v * state.v).sum(0)
    mv2 = 0.5 * params.mass[state.ptype.long()] * vsq
    return {"max|v|": float(torch.sqrt(vsq[valid].max())),
            "ke": float(mv2[valid].double().sum()),
            "fluid max|v|": float(torch.sqrt(vsq[fluid].max())),
            "fluid ke": float(mv2[fluid].double().sum())}


def _noisy(torch, state):
    """``state`` with the thermal noise's inputs of the parity phases: the
    step THERMAL_STEP, the key THERMAL_KEY and e = THERMAL_E on the valid
    slots where the model sets none."""
    return dataclasses.replace(
        state, e=torch.where(state.valid, torch.where(
            state.e != 0, state.e, THERMAL_E), 0.0),
        step=torch.full_like(state.step, THERMAL_STEP),
        key=torch.tensor(THERMAL_KEY, dtype=torch.int64, device=state.x.device))


def _raised_kb(pair, state, params, geom, cfg):
    """kB at which the plain path's random force is 20x the largest force
    without it: the force scales as sqrt(kB), so one evaluation at kB = 1
    sizes it."""
    noise = pair.noise_inputs(state)
    pf = pair._per_particle(state, params, cfg)
    off = pair._pass_a_plain(pf, params, geom,
                             dataclasses.replace(cfg, thermal=False))["f"]
    one = pair._pass_a_plain(pf, dataclasses.replace(params, boltz=1.0), geom,
                             cfg, noise)["f"]
    return float((20 * off.abs().max() / (one - off).abs().max()) ** 2)


def _thermal_rows(torch, pair, kernel, state, params, geom, cfg0, names, tag,
                  fluid_e=THERMAL_E):
    """The thermal rows of ``kernel`` against the plain loop on ``state``
    with the noise's parity inputs (``_noisy``), both filter variants, every
    field within TOL: case (a) at the state's kB, case (b) at the raised kB
    (``_raised_kb``).  Then, on the kernel's own outputs at case (b)'s kB:
    the noise present (at least 10x the largest force without it), pair-
    symmetric (its sum over an all-fluid copy with uniform e = ``fluid_e``
    within 1e-6 x its max x sqrt(particles)) and changed by the next step.
    The sum is read as the difference of two forces, so it resolves the
    noise only where the noise is not far below the force without it: a
    fluid at rest moved by seeded velocities and densities everywhere needs
    the e at which kB was raised (1), not THERMAL_E.  Returns ({case: the
    worst field's rel err}, max abs err, case (b)'s kB, the checks)."""
    state = _noisy(torch, state)
    cfg = dataclasses.replace(cfg0, thermal=True)
    kb = _raised_kb(pair, state, params, geom, cfg)
    errs, worst = {}, 0.0
    for case, p in (("a", params), ("b", dataclasses.replace(params, boltz=kb))):
        err, err_abs, _ = _pass_a_parity(torch, pair, kernel, state, p, geom, cfg,
                                         names, f"{tag} case ({case})")
        errs[case], worst = max(err.values()), max(worst, err_abs)
    p = dataclasses.replace(params, boltz=kb)

    def force(s, thermal=True):
        c = dataclasses.replace(cfg, thermal=thermal)
        return kernel(pair._per_particle(s, p, c), p, geom, c,
                      pair.noise_inputs(s))["f"]

    off, on = force(state, False), force(state)
    rand = on - off
    fluid = dataclasses.replace(
        state, solid_tag=torch.zeros_like(state.solid_tag),
        fixed_tag=torch.zeros_like(state.fixed_tag),
        e=torch.where(state.valid, fluid_e, 0.0))
    frand = torch.where(fluid.valid, force(fluid) - force(fluid, False), 0.0)
    total = float(frand.double().sum(dim=(1, 2)).abs().max())
    n = int(state.valid.sum())
    later = force(dataclasses.replace(state, step=state.step + 1)) - off
    checks = {
        "noise >= 10x max|f| without it":
            float(rand.abs().max()) >= 10 * float(off.abs().max()),
        "pair-symmetric": total <= 1e-6 * float(frand.abs().max()) * n ** 0.5,
        "the next step draws other noise":
            float((later - rand).abs().max()) > 0.1 * float(rand.abs().max()),
    }
    if not all(checks.values()):
        raise AssertionError(f"{tag}: {checks}; |sum f_random| {total!r}")
    checks["|sum f_random| / max"] = total / float(frand.abs().max())
    return errs, worst, kb, checks


def _move_parity(torch, S, rebin_cuda, kernel, state, geom, drop, tag):
    """Kernel vs plain walk vs sort rebin: every leaf bitwise.  Returns a
    description of the packs and the rebinned state, and the kernel's
    max|diff| from the plain walk (0 when bitwise)."""
    PF, PI, xr = _packed(S, rebin_cuda, state, geom, drop)
    kf, ki = kernel(PF, PI, geom, xr)
    wf, wi = rebin_cuda.rebin_move_plain(PF, PI, geom, xr)
    if not (torch.equal(kf, wf) and torch.equal(ki, wi)):
        raise AssertionError(f"{tag} rows differ from the plain walk")
    by_kernel = S.rebin(state, geom, drop=drop, use_kernel=True)
    by_sort = S.rebin(state, geom, drop=drop, use_kernel=False)
    for f in dataclasses.fields(by_sort):
        if not torch.equal(getattr(by_sort, f.name), getattr(by_kernel, f.name)):
            raise AssertionError(f"{tag} rebin != sort rebin on leaf {f.name}")
    return (f"{PF.shape[0]} f32 + {PI.shape[0]} i32 rows, "
            f"{int(by_kernel.n_valid)} particles, overflow "
            f"{int(by_kernel.overflow)}"), float((kf - wf).abs().max())


def _synthetic_edges(geom, pattern=(7, 9)):
    """``geom`` with x columns of alternating widths 7/8 and 9/8 of a cell
    on the cell/8 quantum (``tests/test_halo_kernels.py``'s construction),
    its drift budget narrowed to the narrowest column as ``Scene.balance``
    sets it."""
    import numpy as np

    nx = geom.ncells[0]
    q = geom.cell_size[0] / 8.0
    widths = [pattern[i % len(pattern)] for i in range(nx)]
    if nx % len(pattern):  # keep total coverage exact
        widths[-1] = 8 * nx - sum(widths[:-1])
    bins = np.concatenate([[0], np.cumsum(widths)])
    wmin = float(min(widths) * q)
    budget = min([(wmin - geom.cutoff) / 2.0]
                 + [(geom.cell_size[ax] - geom.cutoff) / 2.0
                    for ax in range(1, geom.dim)])
    return dataclasses.replace(
        geom, x_edges=tuple(float(geom.lo[0] + b * q) for b in bins),
        x_quantum=float(q), base_occ=0,
        cell_size=(wmin,) + tuple(geom.cell_size[1:]),
        drift_budget=max(float(budget), 0.0))


def _seeded_drift(torch, state, geom, seed):
    """``state`` with every valid particle moved by a seeded step of up to
    0.9 of the narrowest cell per axis (within one ring of the cell its
    slot belongs to), a seeded tenth snapped onto an edge of that cell's x
    column; positions beyond a periodic axis's ends stay unwrapped, as
    between two rebins."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = state.x.cpu().numpy()
    valid = state.valid.cpu().numpy()
    d = rng.uniform(-0.9, 0.9, x.shape) * np.asarray(geom.cell_size)[:, None, None]
    d[geom.dim:] = 0.0
    x = x + np.where(valid, d, 0.0)
    col = np.broadcast_to(np.arange(geom.ncells_total), valid.shape) // int(
        np.prod(geom.ncells[1:]))
    snap = valid & (rng.uniform(size=valid.shape) < 0.1)
    side = rng.integers(0, 2, valid.shape)
    x[0] = np.where(snap, np.asarray(geom.x_edges)[col + side], x[0])
    return dataclasses.replace(
        state, x=torch.as_tensor(x.astype(np.float32), device=state.x.device))


def _current_geom(geom, log):
    """The geometry a ``simulate`` run with ``balance_log=log`` ended on:
    its last accepted re-cut's, else the one it started from."""
    cuts = [c["geom"] for c in log if c["geom"] is not None]
    return cuts[-1] if cuts else geom


def _per_call_ms(torch, fn, iters, warmup=2):
    """Mean ms per call of ``fn`` over ``iters`` calls after ``warmup``
    warm-up calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _host_ms(torch, fn, iters):
    """Mean ms of the host clock to issue one call of ``fn``, the card idle
    before each call and its work not waited for."""
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * total / iters


def _clone(torch, state):
    """A copy of ``state`` that shares no storage with it."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def _timed_chunks(torch, simulate, state, params, spec, steps):
    """``simulate(steps)`` timed chunk by chunk: the callback reads the
    host clock and records a CUDA event after every chunk.  Returns (state,
    balance log, seconds, [(first step, host ms, device-timeline ms)] per
    chunk); a chunk's time includes the balance check or re-cut before it."""
    marks, log = [], []

    def mark(_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((time.perf_counter(), ev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mark(None)
    state = simulate(state, params, spec, steps, callback=mark,
                     balance_log=log)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    chunks = [(i * spec.rebin_every, 1e3 * (b[0] - a[0]), a[1].elapsed_time(b[1]))
              for i, (a, b) in enumerate(zip(marks, marks[1:]))]
    return state, log, secs, chunks


def _chunk_split(chunks, log, every):
    """Median (host ms, device-timeline ms) and count of the chunks without
    a balance check ("plain"), of those after a check that kept the
    geometry ("check") and of those after an accepted re-cut ("recut")."""
    import numpy as np

    cut = {c["step"] for c in log if c["geom"] is not None}
    kinds = {"plain": [], "check": [], "recut": []}
    for step, host, device in chunks:
        kind = ("plain" if not every or step == 0 or step % every
                else "recut" if step in cut else "check")
        kinds[kind].append((host, device))
    return {k: (tuple(float(m) for m in np.median(v, axis=0)), len(v))
            for k, v in kinds.items() if v}


def _bound(nbytes, flops, int_ops=0):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes``, do ``flops`` f32 operations and issue ``int_ops`` 32-bit
    integer operations, at its peak rates."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(flops / PEAK_F32, int_ops / PEAK_INT32)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _packed_bytes(slots, n_valid, rows_in, rows_out):
    """The bytes a kernel on 4-byte packed rows must move at this
    occupancy: the valid row (the first input row) of every slot and the
    other input rows of the ``n_valid`` valid slots read once, and every
    output row of every slot written once."""
    return 4 * (slots + n_valid * (rows_in - 1) + slots * rows_out)


def _move_timing(torch, S, rebin_cuda, kernel, state, geom, drop, iters):
    """Per-call ms of the move ``kernel`` and of the plain walk on this
    state's packs, and the move's bound at the state's occupancy (its
    rows in and out are the packs'; its integer compares are not
    counted)."""
    PF, PI, xr = _packed(S, rebin_cuda, state, geom, drop)
    slots = geom.cap * geom.ncells_total
    rows = PF.shape[0] + PI.shape[0]
    return {
        "move": _per_call_ms(torch, lambda: kernel(PF, PI, geom, xr), iters),
        "move_plain": _per_call_ms(
            torch, lambda: rebin_cuda.rebin_move_plain(PF, PI, geom, xr), iters),
        "move_bound": _bound(_packed_bytes(slots, int(state.n_valid), rows,
                                           rows), 0),
        "move_rows": rows,
    }


def _pass_a_work(torch, S, pair, state, geom, h):
    """(valid candidates, pairs inside the support h) of one pass A on this
    state: the data-dependent work its bound counts, offset by offset."""
    valid, x = state.valid, state.x
    not_diag = ~torch.eye(geom.cap, dtype=torch.bool, device=x.device)[:, :, None]
    pbc = pair._pbc(geom)
    cand = inside = 0
    for off in geom.stencil_offsets():
        both = valid[:, None, :] & S.shift_cells(valid, off, geom)[None, :, :]
        if off == (0, 0, 0):
            both = both & not_diag
        d = pair._pair_delta(x[:, :, None, :],
                             S.shift_cells(x, off, geom)[:, None, :, :], pbc)
        cand += int(both.sum())
        inside += int((both & ((d * d).sum(0) < h * h)).sum())
    return cand, inside


def _pass_a_rows(pair_cuda, pf, geom, cfg, kernel):
    """(packed input rows, output rows) of one call of ``kernel``: the full
    body's (K2's, and K1's, K4's and K3's where ``tv_body`` is False) or
    the transport-velocity body's."""
    if kernel == "pass_a_2d_rowloop" or not pair_cuda.tv_body(geom, cfg):
        elastic = cfg.elastic_present
        names = pair_cuda.MECH_PF_ROWS + (("AS", "S") if elastic else ("ASd",))
        accs = pair_cuda.MECH_ACC_ROWS + ((("dS", 9),) if elastic else ())
    else:
        names, accs = pair_cuda.PF_ROWS, pair_cuda.ACC_ROWS
    if cfg.density_filter_accs:
        names, accs = names + ("rhoI",), accs + pair_cuda.FILTER_ACC_ROWS
    if cfg.thermal:
        names += pair_cuda.THERMAL_ROWS
    cap, NC = pf["rho"].shape
    ns = pf["C"].shape[0]  # the C rows in, the Q rows out
    return (sum(pf[n].reshape(-1, cap, NC).shape[0] for n in names) + ns,
            sum(n for _, n in accs) + ns)


def _golden_lmp(steps, every, integrator="ssa_tsdpd/bvf/transportVelocity"):
    """``tools/ssa_golden.scenario_lmp``'s script, its dump in the output
    directory with the velocity added, under ``integrator``."""
    L, rho0, c0, kappa, dt = 1.0e-3, 1000.0, 0.1, 5.0e-7, 1e-5
    delta = L / GOLDEN_NXP
    h = 2.6 * delta
    mass = rho0 * L * L / (GOLDEN_NXP * GOLDEN_NXP)
    return f"""
dimension          2
units              si
atom_style         ssa_tsdpd/atomic 0 1 0
boundary           f f p
newton             off
region             box block 0 {L} 0 {L} {-delta/2} {delta/2} units box
create_box         1 box
lattice            sq {delta} origin 0.5 0.5 0.0
create_atoms       1 region box
mass               1 {mass}
set                group all ssa_tsdpd/rho {rho0}
set                group all ssa_tsdpd/e 0.
set                group all ssa_tsdpd/solid_tag 1 fixed
region             left block 0 {L/2} 0 {L} {-delta/2} {delta/2} units box
group              leftg region left
set                group leftg ssa_tsdpd/Cd 0 {GOLDEN_CD0}
pair_style         ssa_tsdpd/bvf/transportVelocity
pair_coeff         1 1 {rho0} {c0} 1e-3 {h} {h} 0 {kappa}
fix                integration all {integrator}
compute            cd all ssa_tsdpd/Cd/atom 0
dump               dmp all custom {every} ssa_*.txt id x y vx vy c_cd
timestep           {dt}
run                {steps}
"""


def _read_dump(path):
    """A ``dump custom`` file's columns by name, rows sorted by id."""
    import numpy as np

    lines = Path(path).read_text().splitlines()
    n = int(lines[lines.index("ITEM: NUMBER OF ATOMS") + 1])
    head = next(i for i, l in enumerate(lines) if l.startswith("ITEM: ATOMS"))
    cols = lines[head].split()[2:]
    data = np.loadtxt(lines[head + 1: head + 1 + n], ndmin=2)
    data = data[np.argsort(data[:, cols.index("id")], kind="stable")]
    return {c: data[:, k] for k, c in enumerate(cols)}


def _compacted(state) -> bool:
    """Is every cell's set of valid slots a prefix of its slot rows (what
    K5's row stop rests on)?"""
    v = state.valid
    return not bool((v[1:] & ~v[:-1]).any())


def _ssa_paths(torch, dev, card, kind, counters, card_vs_cpu):
    """The stochastic species, the four remaining integrators and the
    LAMMPS-script front end on the card: [main lmp ssa] (N=200 through
    ``__main__.main``), [K5 ssa], [speed lmp ssa] (N=1000), [main ssa
    golden], [main integrators], [ensemble].  Each phase prints its
    seconds."""
    import os

    import numpy as np

    from sph_bvf_tpu_torch import __main__ as entry
    from sph_bvf_tpu_torch.api import lmp
    from sph_bvf_tpu_torch.core import rebin_cuda
    from sph_bvf_tpu_torch.core import state as S
    from sph_bvf_tpu_torch.core.stepper import (_rebin_drop, run_chunk, setup,
                                                simulate)
    from sph_bvf_tpu_torch.io import vtk
    from sph_bvf_tpu_torch.ops import pair, pair_cuda
    from sph_bvf_tpu_torch.parallel import ensemble

    root = Path(__file__).resolve().parent
    work = root / "build" / "chip_smoke_ssa"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    script = LMP_SSA_SCRIPT.read_text()

    def reset():
        for c in counters.values():
            c.launches = 0
        pair._pass_a_qd.calls = 0

    def launches():
        out = {k: c.launches for k, c in counters.items() if c.launches}
        out["qd_pass"] = pair._pass_a_qd.calls
        return out

    def molecules(state):
        return int(torch.where(state.valid, state.Cd, 0).sum())

    # -- [main lmp ssa]: the script at N=200 through the entry point --------
    t_phase = time.perf_counter()
    N = LMP_SSA_N[0]
    steps, dt = LMP_SSA_STEPS[N], LMP_SSA_DT[N]
    out_dir = work / "cavity"
    log = out_dir / "log.cavity_ssa"
    argv = ["-in", str(LMP_SSA_SCRIPT), "-var", "N", str(N), "-var", "dt",
            repr(dt), "-var", "nsteps", str(steps), "-var", "every",
            str(LMP_SSA_EVERY), "-log", str(log), "--out", str(out_dir),
            "--device", str(dev)]
    result = {}
    reset()
    t0 = time.perf_counter()
    if entry.main(argv, result=result) != 0:
        raise AssertionError("[main lmp ssa] the entry point failed")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    run_launches = launches()
    state, params, spec = result["state"], result["params"], result["spec"]
    frames = [out_dir / f"cavity_ssa_{s}.vtk"
              for s in range(0, steps + 1, LMP_SSA_EVERY)]
    _, f0 = vtk.read_vtk(str(frames[0]))
    n0, total0 = len(f0["id"]), int(f0["c_cd"].sum())
    (rx,) = spec.ssa.reactions
    p = math.exp(-rx.k_rate * steps * dt)
    expect, sd = total0 * p, math.sqrt(total0 * p * (1.0 - p))
    total = molecules(state)
    fluid = state.valid & (state.solid_tag == 0)
    rho_dev = float((state.rho[fluid] - 1.0).abs().max())
    rho_mean = float(state.rho[fluid].mean())
    vmax = float(torch.sqrt((state.v * state.v).sum(0))[state.valid].max())
    thermo_rows = [l for l in log.read_text().splitlines()
                   if l.startswith("step")]
    want = {"pass_a_2d": steps + 1, "rebin_move_2d": steps // spec.rebin_every + 1,
            "qd_pass": steps + 1}
    checks = {
        "finite": all(bool(torch.isfinite(getattr(state, n)).all())
                      for n in ("x", "v", "vest", "rho")),
        "overflow 0": int(state.overflow) == 0,
        "drift_violation 0": int(state.drift_violation) == 0,
        "particles conserved": int(state.n_valid) == n0,
        "step": int(state.step) == steps,
        "max|v| <= 1.1": vmax <= 1.1,
        "fluid max|rho-1| <= 0.05": rho_dev <= 0.05,
        "fluid |mean rho-1| <= 0.002": abs(rho_mean - 1.0) <= 0.002,
        "slots compacted": _compacted(state),
        "molecules within 5 sd": abs(total - expect) <= 5.0 * sd,
        "frames": all(f.exists() for f in frames),
        "thermo rows": len(thermo_rows) == steps // 100 + 1,
        "launches": run_launches == want,
    }
    detail = (f"{n0} particles, max|v| {vmax!r}, fluid max|rho-1| {rho_dev!r}, "
              f"fluid mean rho {rho_mean!r}; molecules {total0} -> {total} "
              f"(total0 e^-kt {expect!r}, 5 binomial sd {5 * sd!r}); "
              f"launches {run_launches} (expected {want})")
    if not all(checks.values()):
        raise AssertionError(f"[main lmp ssa] invariants failed: {checks}; "
                             f"{detail}")
    # steady state: 100 more steps of the run's state, timed alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    simulate(state, params, spec, 100)
    torch.cuda.synchronize()
    steady = n0 * 100 / (time.perf_counter() - t0)
    print(f"[main lmp ssa] python -m sph_bvf_tpu_torch -in "
          f"examples/lid_cavity_ssa.lmp -var N {N} ({steps} steps, VTK frames "
          f"every {LMP_SSA_EVERY}, -log) in {secs!r} s: {detail}; "
          f"{n0 * steps / secs!r} particle-steps/s end to end (build, output "
          f"and checks included), {steady!r} over 100 more steps "
          f"[{card}] (phase {time.perf_counter() - t_phase!r} s)")

    # -- [K5 ssa]: the move with the Cd row, 10 steps after a rebin ---------
    t_phase = time.perf_counter()
    what, k5_abs = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_2d,
                                state, spec.geom, _rebin_drop(spec), "K5 ssa")
    print(f"[K5 ssa] rebin move kernel == plain walk == sort rebin, bitwise, "
          f"on the [main lmp ssa] state at step {int(state.step)} (its last "
          f"rebin at step {int(state.step) - spec.rebin_every}; {what}, the "
          f"Cd row among the i32 rows) (phase "
          f"{time.perf_counter() - t_phase!r} s)")
    del state, result

    # -- [speed lmp ssa]: the script at N=1000 ------------------------------
    t_phase = time.perf_counter()
    N = LMP_SSA_N[1]
    steps, dt = LMP_SSA_STEPS[N], LMP_SSA_DT[N]
    model = lmp.parse_script(script, overrides={"N": N, "dt": dt,
                                                "nsteps": steps})
    state, params, spec = model.build(device=dev)
    n0 = int(state.n_valid)
    state = setup(state, params, spec, dt=dt)
    simulate(_clone(torch, state), params, spec, spec.rebin_every)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = simulate(state, params, spec, steps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not (int(state.overflow) == 0 and int(state.n_valid) == n0
            and bool(torch.isfinite(state.v).all()) and _compacted(state)):
        raise AssertionError("[speed lmp ssa] the N=1000 run lost particles, "
                             "left its slots uncompacted or went non-finite")
    cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
    pf = pair._per_particle(state, params, cfg)
    noise = pair.noise_inputs(state)
    k1_ms, _ = _kernel_device_ms(
        torch, lambda: pair_cuda.pass_a_2d(pf, params, spec.geom, cfg, noise),
        "pa2d::window_", 5)
    # every kernel the Qd pass launches ("" matches every name): ms per
    # kernel and kernels over 3 calls
    qd_per_kernel, qd_count = _kernel_device_ms(
        torch, lambda: pair._pass_a_qd(pf, params, spec.geom, cfg, noise), "", 3)
    qd_ms, qd_kernels = qd_per_kernel * qd_count / 3, qd_count / 3
    qd_call = _per_call_ms(
        torch, lambda: pair._pass_a_qd(pf, params, spec.geom, cfg, noise), 3)
    mu = float(pair.compute_ssa_mu_max(state, params, spec.geom, spec.pair))
    print(f"[speed lmp ssa] examples/lid_cavity_ssa.lmp -var N {N} -var dt "
          f"{dt!r}: {n0} particles, cap {spec.geom.cap}, {steps} steps from "
          f"the set-up state in {secs!r} s = {n0 * steps / secs!r} "
          f"particle-steps/s; device ms a step: the Qd pass {qd_ms!r} "
          f"({qd_kernels!r} kernels; {qd_call!r} ms as called, CUDA events) "
          f"beside K1's {k1_ms!r} (torch.profiler); max hop mean {mu!r} "
          f"[{card}] (phase {time.perf_counter() - t_phase!r} s)")
    del state, pf

    # -- [main ssa golden]: the entry point as a process of its own on the
    # card, beside the port's CPU run of the same script
    t_phase = time.perf_counter()
    golden = work / "golden.lmp"
    golden.write_text(_golden_lmp(GOLDEN_STEPS, GOLDEN_STEPS))
    card_dir, cpu_dir = work / "golden_card", work / "golden_cpu"
    # the card's process and the CPU run side by side, the CPU run on one
    # core fewer than the host's
    proc = subprocess.Popen(
        [sys.executable, "-m", "sph_bvf_tpu_torch", "-in", str(golden),
         "--out", str(card_dir), "--device", str(dev)], cwd=str(root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads - 1))
    t0 = time.perf_counter()
    try:
        lmp.parse_script(golden.read_text()).run(
            out_dir=str(cpu_dir), thermo=False, device="cpu")
        cpu_s = time.perf_counter() - t0
        out, err = proc.communicate(timeout=600)
        card_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or f"on {kind}" not in out:
        raise AssertionError(f"[main ssa golden] the entry point's process "
                             f"failed (rc {proc.returncode}): {out[-2000:]} "
                             f"{err[-2000:]}")
    a = _read_dump(card_dir / f"ssa_{GOLDEN_STEPS}.txt")
    b = _read_dump(cpu_dir / f"ssa_{GOLDEN_STEPS}.txt")
    total0 = GOLDEN_CD0 * (GOLDEN_NXP // 2) * GOLDEN_NXP
    differ = int((a["c_cd"] != b["c_cd"]).sum())
    edges = np.linspace(0.0, 1.0e-3, GOLDEN_BINS + 1)
    bins = [np.histogram(d["x"], edges, weights=d["c_cd"])[0] for d in (a, b)]
    bin_gap = float(np.abs(bins[0] - bins[1]).max())
    checks = {
        "ids equal": bool((a["id"] == b["id"]).all()),
        "card total within 2": abs(int(a["c_cd"].sum()) - total0) <= 2,
        "cpu total within 2": abs(int(b["c_cd"].sum()) - total0) <= 2,
        "v exactly 0": not (a["vx"].any() or a["vy"].any()),
        "Cd differs on <= 1%": differ <= 0.01 * len(a["id"]),
        "x bins within 1% of total0/bins": bin_gap <= 0.01 * total0 / GOLDEN_BINS,
    }
    if not all(checks.values()):
        raise AssertionError(f"[main ssa golden] {checks}: {differ} "
                             f"particles' Cd differ, bins {bins}")
    print(f"[main ssa golden] python -m sph_bvf_tpu_torch -in golden.lmp (a "
          f"process of its own: '{out.strip().splitlines()[-1]}', "
          f"{card_s!r} s to its end) vs the port's CPU run ({cpu_s!r} s), "
          f"{GOLDEN_STEPS} steps, f32: totals "
          f"{int(a['c_cd'].sum())} / {int(b['c_cd'].sum())} (total0 {total0}),"
          f" Cd differs on {differ} of {len(a['id'])} particles, x-bin totals "
          f"(card) {bins[0].astype(int).tolist()}, largest card-CPU bin gap "
          f"{bin_gap!r} (bound {0.01 * total0 / GOLDEN_BINS!r}), v 0 "
          f"(phase {time.perf_counter() - t_phase!r} s)")

    # -- [main integrators]: bvf, artificialStress and zhang on the cavity
    # script (pass B on), card against CPU; stationary on the crystal
    t_phase = time.perf_counter()
    fix_line = "integration all ssa_tsdpd/bvf/transportVelocity"
    k1 = {}
    for fix in INTEG_FIXES:
        text = script.replace(fix_line, f"integration all {fix}")
        build = (lambda d, t=text: (*lmp.parse_script(
            t, overrides={"N": INTEG_N}).build(device=d), None))
        reset()
        s = card_vs_cpu(f"cavity N={INTEG_N} (SSA species) "
                        f"with fix {fix}", "integrators", build, 1e-4,
                        ("x", "v", "rho"))
        k1[fix] = counters["pass_a_2d"].launches
        if not (k1[fix] == INTEG_STEPS + 1 and float(s.vws.abs().max()) > 0):
            raise AssertionError(f"[main integrators] {fix}: K1 launches "
                                 f"{k1[fix]}, max|vws| {float(s.vws.abs().max())}")
    golden_st = lmp.parse_script(_golden_lmp(
        INTEG_STEPS, INTEG_STEPS, integrator="ssa_tsdpd/stationary"))
    state, params, spec = golden_st.build(device=dev)
    state = setup(state, params, spec, dt=golden_st.dt)
    before = S.gather_particles(state, spec.geom, ("x", "v", "Cd"))
    state = simulate(state, params, spec, INTEG_STEPS)
    after = S.gather_particles(state, spec.geom, ("x", "v", "Cd"))
    if not (np.array_equal(before["x"], after["x"])
            and np.array_equal(before["v"], after["v"])
            and not np.array_equal(before["Cd"], after["Cd"])):
        raise AssertionError("[main integrators] stationary moved the crystal "
                             "or froze its molecules")
    print(f"[main integrators] K1 launches on the card runs {k1} (pass B on, "
          f"vws nonzero); fix ssa_tsdpd/stationary on the golden crystal, "
          f"{INTEG_STEPS} steps: x and v bitwise unchanged, Cd moved "
          f"(phase {time.perf_counter() - t_phase!r} s)")

    # -- [ensemble]: replicas of the golden scenario ------------------------
    t_phase = time.perf_counter()
    model = lmp.parse_script(_golden_lmp(ENSEMBLE_STEPS, ENSEMBLE_STEPS))
    state, params, spec = model.build(device=dev)
    state = setup(state, params, spec, dt=model.dt)
    total0 = molecules(state)
    stacked = ensemble.stack_replicas(state, ENSEMBLE_R, ENSEMBLE_SEED0)
    single = dataclasses.replace(state, key=torch.tensor(
        [0, ENSEMBLE_SEED0], dtype=torch.int64, device=dev))
    freq = spec.integ.freq_filter
    reset()
    for done in range(0, ENSEMBLE_STEPS, spec.rebin_every):
        phase = (int(state.step) + done) % freq
        stacked = ensemble.run_chunk_ensemble(stacked, params, spec,
                                              spec.rebin_every, phase)
    ens_launches = launches()
    for done in range(0, ENSEMBLE_STEPS, spec.rebin_every):
        phase = (int(state.step) + done) % freq
        single = run_chunk(single, params, spec, spec.rebin_every, phase)
    reps = [ensemble.replica(stacked, r) for r in range(ENSEMBLE_R)]
    same = all(torch.equal(getattr(reps[0], f.name), getattr(single, f.name))
               for f in dataclasses.fields(single))
    distinct = all(not torch.equal(reps[i].Cd, reps[j].Cd)
                   for i in range(ENSEMBLE_R) for j in range(i))
    totals = [molecules(r) for r in reps]
    if not (same and distinct and all(abs(t - total0) <= 2 for t in totals)):
        raise AssertionError(f"[ensemble] replica 0 == single run {same}, "
                             f"replicas distinct {distinct}, totals {totals} "
                             f"(total0 {total0})")
    print(f"[ensemble] {ENSEMBLE_R} replicas of the golden scenario, "
          f"{ENSEMBLE_STEPS} steps (seed0 {ENSEMBLE_SEED0}): replica 0 "
          f"bitwise the single run with key [0, {ENSEMBLE_SEED0}], the "
          f"replicas' Cd pairwise different, totals {totals} (total0 "
          f"{total0}); launches {ens_launches} [{card}] (phase "
          f"{time.perf_counter() - t_phase!r} s)")
    shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need a card",
              file=sys.stderr)
        return 2

    from sph_bvf_tpu_torch import _build
    from sph_bvf_tpu_torch.api.scene import Region, Scene
    from sph_bvf_tpu_torch.core import computes, rebin_cuda
    from sph_bvf_tpu_torch.core import stepper as stepper_mod
    from sph_bvf_tpu_torch.core import state as S
    from sph_bvf_tpu_torch.core.fixes import SetForce
    from sph_bvf_tpu_torch.core.stepper import _rebin_drop, setup, simulate
    from sph_bvf_tpu_torch.io import checkpoint, vtk
    from sph_bvf_tpu_torch.models import (cell_polarization, drift_blob, fsi,
                                          lid_cavity, lid_cavity3d,
                                          natural_convection, taylor_green2d,
                                          taylor_green3d)
    from sph_bvf_tpu_torch.ops import pair, pair_cuda
    from sph_bvf_tpu_torch.ops import rotation_probe as rp
    from sph_bvf_tpu_torch.parallel.balance import rebalance, report
    from sph_bvf_tpu_torch.utils.thermo import ThermoLogger

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    counters = {"pass_a_2d": pair_cuda.pass_a_2d,
                "pass_a_2d_preshift": pair_cuda.pass_a_2d_preshift,
                "pass_a_2d_rowloop": pair_cuda.pass_a_2d_rowloop,
                "pass_a_3d": pair_cuda.pass_a_3d,
                "rebin_move_2d": rebin_cuda.rebin_move_2d,
                "rebin_move_2d_gated": rebin_cuda.rebin_move_2d_gated,
                "rebin_move_3d": rebin_cuda.rebin_move_3d,
                "probe_slice": rp.probe_slice, "probe_mma": rp.probe_mma,
                "probe_base": rp.probe_base}

    def pass_a_timing(pass_a, state, params, geom, cfg, iters, piece=None,
                      plain_iters=None):
        """Per-call ms of the wrapper ``pass_a`` and of the plain loop (over
        ``piece`` target cells at a time, all at once by default; over
        ``plain_iters`` calls, ``iters`` by default) on this
        state, and pass A's bound from these inputs at
        the state's occupancy: the packed rows in and out, the valid
        candidates, the pairs inside the support h (with the thermal noise,
        their hash and Box-Muller too) and, with species, those inside
        cutc.  K4's bound is K1's: its 9 staged copies of the pack are its
        own way of computing the function, not bytes the function needs."""
        pf = pair._per_particle(state, params, cfg)
        noise = pair.noise_inputs(state)
        n, slots = int(state.n_valid), geom.cap * geom.ncells_total
        rows_in, rows_out = _pass_a_rows(pair_cuda, pf, geom, cfg,
                                         pass_a.__name__)
        nbytes = _packed_bytes(slots, n, rows_in, rows_out)
        cand, inside = _pass_a_work(torch, S, pair, state, geom, params.max_cut)
        flops = FLOPS_CANDIDATE * cand + FLOPS_PAIR * inside
        int_ops = 0
        if cfg.thermal:
            flops += FLOPS_THERMAL_PAIR[geom.dim] * inside
            int_ops = INT_OPS_THERMAL_PAIR[geom.dim] * inside
        ns = params.n_sdpd
        inside_c = 0
        if ns:
            _, inside_c = _pass_a_work(torch, S, pair, state, geom,
                                       float(params.cutc.max()))
            flops += (FLOPS_SPECIES_PAIR + FLOPS_PER_SPECIES * ns) * inside_c
        return {
            "pass_a": _per_call_ms(
                torch, lambda: pass_a(pf, params, geom, cfg, noise), iters),
            # no warm-up call where the plain pass is timed once (up to 13
            # s a call on the 3D grids)
            "pass_a_plain": _per_call_ms(
                torch, lambda: pair._pass_a_plain(pf, params, geom, cfg, noise,
                                                  cells_per_piece=piece),
                plain_iters or iters, warmup=0 if plain_iters == 1 else 2),
            "pass_a_bound": _bound(nbytes, flops, int_ops),
            "pass_a_rows": rows_in,
            "pass_a_work": (f"{rows_in} + {rows_out} rows, {cand} candidates, "
                            f"{inside} pairs inside the support"
                            + (f", {inside_c} inside cutc with {ns} species"
                               if ns else "")),
        }

    # -- 1. device ----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = _nvidia_smi("name,power.limit")
    print(f"[device] torch: {kind}; count {torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(card)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(_build.load, name) for name in KERNELS]:
            fut.result()
    build_s = time.perf_counter() - t0
    print(f"[build] {build_s!r} s for {' + '.join(KERNELS)} "
          f"({_build.nvcc_version()}); compile s {_build.build_seconds}")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    # every instantiation, as the runtime reports it (registers, local-memory
    # bytes: the spills, and in the thermal ones the stack frame of cosf's
    # range reduction): K1 (and so K4) and K3 with both bodies (the
    # transport-velocity body "tv": (filter, species count, thermal); the
    # full body of csrc/pass_a_mech.cuh: and elastic), K2 the full body
    for wrapper in (pair_cuda.pass_a_2d, pair_cuda.pass_a_2d_rowloop,
                    pair_cuda.pass_a_3d):
        bodies = ((False,) if wrapper is pair_cuda.pass_a_2d_rowloop
                  else (True, False))
        attrs = {f"{'tv/' if tv else ''}{'filter' if filt else 'nofilter'}/"
                 f"{'elastic' if el else 'plain'}/Ns={ns}"
                 f"{'/thermal' if th else ''}":
                 pair_cuda.kernel_attributes(wrapper, filt, ns, el, th, tv)
                 for tv in bodies for th in (False, True)
                 for ns in range(pair_cuda.MAX_SPECIES + 1)
                 for el in ((False,) if tv else (True, False))
                 for filt in (True, False)}
        print(f"[build] {wrapper.__name__} instantiations (registers per "
              f"thread, local bytes per thread): {attrs}")
    print(f"[build] rebin_move_3d instantiations (slot lists in shared or "
          f"global memory: registers per thread, local bytes per thread; "
          f"{rebin_cuda.K7_CELLS} cells a block, shared up to cap "
          f"{rebin_cuda.K7_LIST_BYTES // (4 * rebin_cuda.K7_CELLS)}): "
          + str({"shared" if sh else "global": rebin_cuda.k7_attributes(sh)
                 for sh in (True, False)}))
    move2d = rebin_cuda.move_2d_attributes()
    print(f"[build] rebin_move_2d kernel (K5 and K6, slot lists in shared "
          f"memory): {move2d}")
    if move2d["local_bytes"]:
        raise AssertionError(f"[build] the 2D move spills to local memory: "
                             f"{move2d}")

    # -- 3. K1 parity -------------------------------------------------------
    state, params, spec, _ = lid_cavity.build(N=CAVITY_N[0], device=dev)
    state = simulate(setup(state, params, spec, dt=1e-4), params, spec,
                     PARITY_STEPS["cavity"])
    geom = spec.geom
    k1_err, k1_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d, state, params, geom, spec.pair,
        ("f", "drho", "num_den", "phi", "nw", "ddv", "de"), "K1")
    print(f"[K1] pass A kernel == plain (N={CAVITY_N[0]}, step "
          f"{int(state.step)}), max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k1_err.items()))

    # -- 4. K5 parity -------------------------------------------------------
    state = simulate(state, params, spec, 10)  # drifted since its last rebin
    what, k5_abs = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_2d,
                                state, geom, _rebin_drop(spec), "K5")
    print(f"[K5] rebin move kernel == plain walk == sort rebin, bitwise "
          f"(N={CAVITY_N[0]}, {what})")

    def edged_check(tag, kernel, state, params, spec, want_pass_a):
        """The x_edges variant of ``kernel`` on ``state`` re-cut into
        synthetic columns: a short ``simulate`` on the edged grid (its
        launches counted), then kernel == plain walk == sort rebin on the
        run's state and on a seeded drift of it.  Returns (launches,
        max|diff|, per-call timing)."""
        geom = _synthetic_edges(spec.geom)
        drop = _rebin_drop(spec)
        state = S.rebin(state, geom, drop=drop, use_kernel=False,
                        drift_check=False)
        if int(state.overflow) or rebin_cuda.move_route(geom) is not kernel:
            raise AssertionError(f"{tag}: the edged grid overflows or does "
                                 f"not route to {kernel.__name__}")
        spec = dataclasses.replace(spec, geom=geom, rebin_every=EDGE_REBIN)
        for c in counters.values():
            c.launches = 0
        state = simulate(state, params, spec, EDGE_STEPS)
        launches = {k: c.launches for k, c in counters.items()}
        want = dict.fromkeys(counters, 0)
        want[kernel.__name__] = EDGE_STEPS // EDGE_REBIN
        want[want_pass_a] = EDGE_STEPS
        if launches != want:
            raise AssertionError(f"{tag} run: launch counts {launches}, "
                                 f"expected {want}")
        what, err = _move_parity(torch, S, rebin_cuda, kernel, state, geom,
                                 drop, tag)
        drifted = _seeded_drift(torch, state, geom, seed=1)
        what_d, err_d = _move_parity(torch, S, rebin_cuda, kernel, drifted,
                                     geom, drop, f"{tag} (seeded drift)")
        # timed on the run's state, as the uniform kernels are; the seeded
        # drift (which overflows) only beside it
        t = _move_timing(torch, S, rebin_cuda, kernel, state, geom, drop, 10)
        t_d = _move_timing(torch, S, rebin_cuda, kernel, drifted, geom, drop, 10)
        print(f"[{tag}] x_edges rebin move kernel == plain walk == sort rebin, "
              f"bitwise ({geom.ncells[0]} x columns of widths 7/8 and 9/8 of "
              f"a cell, drift budget {geom.drift_budget!r}; after "
              f"simulate({EDGE_STEPS}) rebinning every {EDGE_REBIN}: {what}, "
              f"launches {launches[kernel.__name__]}; after a seeded drift: "
              f"{what_d}); per call ms on the run's state {t['move']!r} vs "
              f"plain walk {t['move_plain']!r}, bound {t['move_bound']}; on "
              f"the seeded drift {t_d['move']!r} vs plain walk "
              f"{t_d['move_plain']!r} [{card}]")
        return launches[kernel.__name__], max(err, err_d), t

    k5e_launches, k5e_abs, t_k5e = edged_check(
        "K5 edges", rebin_cuda.rebin_move_2d, state, params, spec,
        "pass_a_2d_rowloop")
    del state

    # -- K1 with the species rows, K5 moving them ---------------------------
    state, params, spec, _ = natural_convection.build(N=CONV_N[0], device=dev)
    state = setup(state, params, spec, dt=CONV_DT[CONV_N[0]])
    geom = spec.geom
    k1s_err, k1s_abs = {}, 0.0
    for when in (0, PARITY_STEPS["convection"]):
        state = simulate(state, params, spec, when - int(state.step))
        cases = [("Ns=1 as run", state, params)]
        cases += [(f"Ns={ns} seeded",
                   *_seed_species(torch, state, params, ns, seed=ns))
                  for ns in SPECIES_NS]
        cases += [(f"Ns=2 cutc={c}h",
                   *_seed_species(torch, state, params, 2, seed=2, cutc_scale=c))
                  for c in SPECIES_CUTC]
        err, err_abs = _species_parity(torch, pair, pair_cuda.pass_a_2d, cases,
                                       geom, spec.pair, f"K1 species step {when}")
        k1s_err[when], k1s_abs = err, max(k1s_abs, err_abs)
    print(f"[K1 species] pass A kernel with C rows == plain, every field and "
          f"Q (natural convection N={CONV_N[0]}, {int(state.n_valid)} "
          f"particles, cap {geom.cap}, {geom.ncells_total} cells, both filter "
          f"variants); per case (Q's max|diff|/max|ref| with / without the "
          f"filter rows, the worst field's): "
          + "; ".join(f"step {when}: " + ", ".join(
              f"{k} {v[0]:.3g} / {v[1]:.3g} ({v[2]:.3g})" for k, v in err.items())
              for when, err in k1s_err.items())
          + f"; max|diff| {k1s_abs!r}")
    del cases
    # drifted since its last rebin: the run's own species, then two
    state = simulate(state, params, spec, 10)
    what, k5s_abs = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_2d,
                                 state, geom, _rebin_drop(spec), "K5 species")
    s2, p2 = _seed_species(torch, state, params, 2, seed=2)
    what2, err2 = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_2d,
                               s2, geom, _rebin_drop(spec), "K5 species Ns=2")
    print(f"[K5 species] rebin move kernel with C rows == plain walk == sort "
          f"rebin, bitwise (natural convection N={CONV_N[0]}, step "
          f"{int(state.step)}: Ns=1 {what}; Ns=2 seeded {what2})")
    del s2, p2

    # -- K1's thermal rows on the convection state, with and without its
    # species -----------------------------------------------------------------
    k1_names = ("f", "drho", "num_den", "phi", "nw", "ddv", "de")
    bare = (dataclasses.replace(state, C=state.C[:0], Q=state.Q[:0]),
            dataclasses.replace(params, kappa=params.kappa[..., :0]))
    k1t, k1t_abs = {}, 0.0
    for label, s_, p_, names in (("Ns=1", state, params, k1_names + ("Q",)),
                                 ("Ns=0", *bare, k1_names)):
        errs, err_abs, kb, checks = _thermal_rows(
            torch, pair, pair_cuda.pass_a_2d, s_, p_, geom, spec.pair, names,
            f"K1 thermal {label}")
        k1t[label], k1t_abs = (errs, kb, checks), max(k1t_abs, err_abs)
    print(f"[K1 thermal] pass A kernel with the thermal rows == plain, every "
          f"field (natural convection N={CONV_N[0]}, step {int(state.step)} "
          f"read as {THERMAL_STEP}, key {THERMAL_KEY}, both filter variants); "
          f"per case the worst field's max|diff|/max|ref| at (a) the SI kB and "
          f"(b) the raised kB, and the checks on (b): "
          + "; ".join(f"{k}: (a) {v[0]['a']:.3g}, (b) {v[0]['b']:.3g} at kB "
                      f"{v[1]:.3g}, {v[2]}" for k, v in k1t.items())
          + f"; max|diff| {k1t_abs!r}")
    del state, bare

    # -- 5. K2 parity -------------------------------------------------------
    state, params, spec, _ = fsi.build(nx=FSI_NX[0],
                                       tdamp_solid=FSI_RELEASE["parity"],
                                       device=dev)
    state = simulate(setup(state, params, spec, dt=1e-8), params, spec,
                     PARITY_STEPS["fsi"])
    geom = spec.geom
    k2_names = ("f", "drho", "de", "num_den", "ddv", "ddx", "dS", "phi", "nw")
    k2_err, k2_abs, ref = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_rowloop, state, params, geom,
        spec.pair, k2_names, "K2")
    ds_run = float(ref["dS"].abs().max())
    # the beam's S seeded so that AS is tensile on some particles
    seeded = _seed_beam_S(torch, state, seed=0)
    as_max = float(pair._per_particle(seeded, params, spec.pair)["AS"].abs().max())
    err_s, abs_s, ref_s = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_rowloop, seeded, params, geom,
        spec.pair, k2_names, "K2 (seeded S)")
    k2_abs = max(k2_abs, abs_s)
    ds_seeded = float(ref_s["dS"].abs().max())
    if not (as_max > 0 and ds_run > 0 and ds_seeded > 0):
        raise AssertionError(f"K2 parity is vacuous: max|AS| {as_max!r}, "
                             f"max|dS| {ds_run!r} / {ds_seeded!r}")
    print(f"[K2] rowloop pass A kernel == plain (fsi nx={FSI_NX[0]}, cap "
          f"{geom.cap}, {geom.ncells_total} cells, step {int(state.step)}, "
          f"beam released at {FSI_RELEASE['parity']}), max|diff|/max|ref| per "
          f"field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k2_err.items())
          + "; beam S seeded (max|AS| " + f"{as_max:.3g}, max|dS| run "
          + f"{ds_run:.3g} / seeded {ds_seeded:.3g}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in err_s.items()))
    # K1's full body and K4 on the same states, forced through the grouped
    # shape (as the JAX package's tests call pass_a_pallas(rowloop=False)):
    # periodic x, mechanics, XSPH, the free elastic beam.  No user path
    # routes such a grid to the grouped kernel, so K1's launches here are
    # those of its parity and timing calls, counted from 0
    k1f_err, k1f_abs = {}, 0.0
    pair_cuda.pass_a_2d.launches = 0
    for label, s_ in (("as run", state), ("S seeded", seeded)):
        err, err_abs, ref = _grouped_parity(
            torch, pair, pair_cuda, s_, params, geom, spec.pair, k2_names,
            f"K1 full body fsi {label}")
        live = {"AS": float(pair._per_particle(s_, params, spec.pair)["AS"]
                            .abs().max()),
                "dS": float(ref["dS"].abs().max()),
                "ddx": float(ref["ddx"].abs().max())}
        if label == "S seeded" and not all(v > 0 for v in live.values()):
            raise AssertionError(f"K1 full body fsi is vacuous: {live}")
        k1f_err[f"fsi nx={FSI_NX[0]} {label}"] = (max(err.values()), live)
        k1f_abs = max(k1f_abs, err_abs)
    cfg_nf = dataclasses.replace(spec.pair, density_filter_accs=False)
    t_k1f = pass_a_timing(pair_cuda.pass_a_2d, seeded, params, geom, cfg_nf, 10)
    k1f_launches = pair_cuda.pass_a_2d.launches
    pf_nf = pair._per_particle(seeded, params, cfg_nf)
    k2_ms = _per_call_ms(torch, lambda: pair_cuda.pass_a_2d_rowloop(
        pf_nf, params, geom, cfg_nf), 10)
    print(f"[K1 full body] grouped pass A kernel, full body == plain, K4 == K1 "
          f"bitwise (fsi nx={FSI_NX[0]}: periodic x, cap {geom.cap}, mechanics, "
          f"XSPH, the free elastic beam, both filter variants); per state the "
          f"worst field's max|diff|/max|ref| and max|AS|, |dS|, |ddx|: "
          + "; ".join(f"{k}: {v[0]:.3g} ({v[1]})" for k, v in k1f_err.items())
          + f"; K1 launches in these parity and timing calls {k1f_launches}"
          f"; S seeded, per call ms: K1 {t_k1f['pass_a']!r} (K2 on it "
          f"{k2_ms!r}) vs plain {t_k1f['pass_a_plain']!r}, bound "
          f"{t_k1f['pass_a_bound']} [{card}]")
    del seeded, ref, ref_s, pf_nf
    k2t_errs, k2t_abs, kb, checks = _thermal_rows(
        torch, pair, pair_cuda.pass_a_2d_rowloop, state, params, geom, spec.pair,
        k2_names, "K2 thermal fsi")
    k2t = {f"fsi nx={FSI_NX[0]} elastic Ns=0": (k2t_errs, kb, checks)}
    # K1's thermal rows on the same FSI state, and K4 bitwise K1 with them
    k1ft_errs, k1ft_abs, kb1, checks1 = _thermal_rows(
        torch, pair, pair_cuda.pass_a_2d, state, params, geom, spec.pair,
        k2_names, "K1 thermal fsi")
    for boltz in (params.boltz, kb1):
        _k4_bitwise(torch, pair, pair_cuda, _noisy(torch, state),
                    dataclasses.replace(params, boltz=boltz), geom,
                    dataclasses.replace(spec.pair, thermal=True),
                    f"K4 thermal fsi kB {boltz!r}")
    k1f_abs = max(k1f_abs, k1ft_abs)
    print(f"[K1 full body thermal] the full body's thermal rows == plain, K4 == "
          f"K1 bitwise (fsi nx={FSI_NX[0]}, elastic, Ns=0, step read as "
          f"{THERMAL_STEP}, both filter variants): the worst field's "
          f"max|diff|/max|ref| at (a) the SI kB {k1ft_errs['a']:.3g}, (b) kB "
          f"{kb1:.3g} {k1ft_errs['b']:.3g}, the checks on (b) {checks1}")

    # -- 6. K6 parity -------------------------------------------------------
    state = simulate(state, params, spec, 50)  # drifted since its last rebin
    what, k6_abs = _move_parity(torch, S, rebin_cuda,
                                rebin_cuda.rebin_move_2d_gated, state, geom,
                                _rebin_drop(spec), "K6")
    print(f"[K6] gated rebin move kernel == plain walk == sort rebin, bitwise "
          f"(fsi nx={FSI_NX[0]}, periodic x, cap {geom.cap}, {what})")
    del state

    # -- 7, 8. K3 and K7 parity at N=40 and the main path's N=100 -----------
    # (the kernels' max|diff| reported is the last size's: the main path's)
    for N in CAVITY3D_N:
        state, params, spec, _ = lid_cavity3d.build(N=N, device=dev)
        state = simulate(setup(state, params, spec, dt=1e-4), params, spec,
                         PARITY_STEPS["cavity3d"])
        geom = spec.geom
        k3_err, k3_abs, _ = _pass_a_parity(
            torch, pair, pair_cuda.pass_a_3d, state, params, geom, spec.pair,
            ("f", "drho", "num_den", "phi", "nw", "ddv", "de"), f"K3 N={N}")
        print(f"[K3] 3D pass A kernel == plain (lid_cavity3d N={N}, cap "
              f"{geom.cap}, {geom.ncells_total} cells, {int(state.n_valid)} "
              f"particles, step {int(state.step)}), max|diff| {k3_abs!r}, "
              f"max|diff|/max|ref| per field: "
              + ", ".join(f"{k} {v:.3g}" for k, v in k3_err.items()))
        state = simulate(state, params, spec, 10)  # drifted since its rebin
        what, k7_abs = _move_parity(torch, S, rebin_cuda,
                                    rebin_cuda.rebin_move_3d, state, geom,
                                    _rebin_drop(spec), f"K7 N={N}")
        print(f"[K7] 3D rebin move kernel == plain walk == sort rebin, "
              f"bitwise (lid_cavity3d N={N}, step {int(state.step)}, {what})")
        if N == CAVITY3D_N[0]:
            cases = [("Ns=1 seeded",
                      *_seed_species(torch, state, params, 1, seed=1)),
                     (f"Ns=2 seeded cutc={SPECIES_CUTC[0]}h",
                      *_seed_species(torch, state, params, 2, seed=2,
                                     cutc_scale=SPECIES_CUTC[0]))]
            k3s_err, k3s_abs = _species_parity(
                torch, pair, pair_cuda.pass_a_3d, cases, geom, spec.pair,
                f"K3 species N={N}")
            print(f"[K3 species] 3D pass A kernel with C rows == plain, every "
                  f"field and Q (lid_cavity3d N={N}, step {int(state.step)}, "
                  f"C seeded, both filter variants); per case (Q's "
                  f"max|diff|/max|ref| with / without the filter rows, the "
                  f"worst field's): "
                  + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g} ({v[2]:.3g})"
                              for k, v in k3s_err.items())
                  + f"; max|diff| {k3s_abs!r}")
            # 10 steps with each case's species (K3 every step, K7 at the
            # chunk's start), then K7 moving the C rows
            k7s_what, t_k3s = [], None
            for label, s3, p3 in cases:
                for c in counters.values():
                    c.launches = 0
                s3 = simulate(s3, p3, spec, 10)
                k3s_launches = pair_cuda.pass_a_3d.launches
                what, _ = _move_parity(
                    torch, S, rebin_cuda, rebin_cuda.rebin_move_3d, s3, geom,
                    _rebin_drop(spec), f"K7 species {label}")
                k7s_what.append(f"{label}: {what}")
                # K3 with species is timed on the first case: one species
                t_k3s = t_k3s or pass_a_timing(
                    pair_cuda.pass_a_3d, s3, p3, geom,
                    dataclasses.replace(spec.pair, density_filter_accs=False), 10,
                    plain_iters=1)
            print(f"[K7 species] 3D rebin move kernel with C rows == plain walk "
                  f"== sort rebin, bitwise (lid_cavity3d N={N}, 10 steps of "
                  f"simulate with each case's species, K3 launched "
                  f"{k3s_launches} times in each: " + "; ".join(k7s_what)
                  + f"); K3 with Ns=1 per call ms {t_k3s['pass_a']!r} vs plain "
                  f"pass A {t_k3s['pass_a_plain']!r}, bound "
                  f"{t_k3s['pass_a_bound']} [{card}]")
            k3t, k3t_abs = {}, 0.0
            for label, s_, p_, names in (
                    ("Ns=0", state, params, k1_names),
                    ("Ns=1 seeded", *cases[0][1:], k1_names + ("Q",))):
                errs, err_abs, kb, checks = _thermal_rows(
                    torch, pair, pair_cuda.pass_a_3d, s_, p_, geom, spec.pair,
                    names, f"K3 thermal N={N} {label}")
                k3t[label], k3t_abs = (errs, kb, checks), max(k3t_abs, err_abs)
            spec_t = _noise_on(spec)
            for c in counters.values():
                c.launches = 0
            st = simulate(_noisy(torch, state), params, spec_t, 10)
            k3t_launches = pair_cuda.pass_a_3d.launches
            t_k3t = pass_a_timing(
                pair_cuda.pass_a_3d, st, params, geom,
                dataclasses.replace(spec_t.pair, density_filter_accs=False), 10,
                plain_iters=1)
            print(f"[K3 thermal] 3D pass A kernel with the thermal rows == "
                  f"plain, every field (lid_cavity3d N={N}, both filter "
                  f"variants); per case the worst field's max|diff|/max|ref| at "
                  f"(a) the SI kB and (b) the raised kB, and the checks on (b): "
                  + "; ".join(f"{k}: (a) {v[0]['a']:.3g}, (b) {v[0]['b']:.3g} "
                              f"at kB {v[1]:.3g}, {v[2]}" for k, v in k3t.items())
                  + f"; max|diff| {k3t_abs!r}; 10 steps with the noise: K3 "
                  f"launched {k3t_launches} times, per call ms "
                  f"{t_k3t['pass_a']!r} vs plain pass A "
                  f"{t_k3t['pass_a_plain']!r}, bound {t_k3t['pass_a_bound']} "
                  f"[{card}]")
            del cases, s3, p3, st
        if N == CAVITY3D_N[1]:
            k7e_launches, k7e_abs, t_k7e = edged_check(
                "K7 edges", rebin_cuda.rebin_move_3d, state, params, spec,
                "pass_a_3d")
        del state

    # -- K3 and K7 on periodic axes: the spanwise cavity at N=40 after
    # seeded jitter, the fully periodic box (one seeded species, the thermal
    # rows) and the x-z periodic channel; K7 after seeded seam drifts -------
    Ns = SPAN_N[0]
    state, params, spec, _ = lid_cavity3d.build_spanwise(Ns, device=dev)
    state = simulate(setup(state, params, spec, dt=1e-4), params, spec,
                     PARITY_STEPS["cavity3d"])
    geom = spec.geom
    state = _jitter(torch, state, 1.0 / Ns, seed=1)
    k3p_err, k3p_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, state, params, geom, spec.pair,
        k1_names, f"K3 periodic spanwise N={Ns}")
    print(f"[K3 periodic] 3D pass A kernel with a periodic y axis == plain "
          f"(spanwise cavity N={Ns}, {geom.ncells} cells, cap {geom.cap}, "
          f"{int(state.n_valid)} particles, step {int(state.step)}, x jittered "
          f"by up to 0.1 spacing), max|diff| {k3p_abs!r}, max|diff|/max|ref| per "
          f"field: " + ", ".join(f"{k} {v:.3g}" for k, v in k3p_err.items()))
    k7p_what = []
    drifted, across = _seam_drift(torch, state, geom, seed=2)
    what, k7p_abs = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                                 drifted, geom, _rebin_drop(spec),
                                 "K7 periodic spanwise")
    k7p_what.append(f"spanwise N={Ns} {geom.ncells}: {what}, across {across}")
    del state, drifted
    for shape in ("channel", "box"):
        state, params, spec = _periodic_grid(Scene, Region, BOX_N, shape).build(
            device=dev)
        geom = spec.geom
        state = setup(_jitter(torch, state, 1.0 / BOX_N, seed=3, stir=True),
                      params, spec, dt=1e-4)
        drifted, across = _seam_drift(torch, state, geom, seed=4)
        what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                                 drifted, geom, _rebin_drop(spec),
                                 f"K7 periodic {shape}")
        k7p_abs = max(k7p_abs, err)
        k7p_what.append(f"{shape} periodic {geom.periodic} {geom.ncells}: "
                        f"{what}, across {across}")
        del drifted
    print(f"[K7 periodic] 3D rebin move kernel on periodic axes == plain walk "
          f"== sort rebin, bitwise, after seeded drifts of up to 0.9 cells, "
          f"outward at the corners: " + "; ".join(k7p_what))
    # the box (its state is the loop's last) with one seeded species, then
    # its thermal rows
    box_cases = [("Ns=1 seeded", *_seed_species(torch, state, params, 1, seed=5))]
    k3pb_err, k3pb_abs = _species_parity(
        torch, pair, pair_cuda.pass_a_3d, box_cases, geom, spec.pair,
        "K3 periodic box species")
    errs, k3pt_abs, kb, checks = _thermal_rows(
        torch, pair, pair_cuda.pass_a_3d, state, params, geom, spec.pair,
        k1_names, "K3 periodic box thermal", fluid_e=1.0)
    k3p_abs = max(k3p_abs, k3pb_abs, k3pt_abs)
    print(f"[K3 periodic] 3D pass A kernel on the fully periodic box == plain "
          f"(N={BOX_N}, {geom.ncells} cells, cap {geom.cap}, "
          f"{int(state.n_valid)} particles, a fixed sphere, x, v and rho "
          f"seeded): with "
          f"one seeded species (Q's max|diff|/max|ref| with / without the "
          f"filter rows, the worst field's) "
          + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g} ({v[2]:.3g})"
                      for k, v in k3pb_err.items())
          + f"; with the thermal rows, the worst field's at (a) the SI kB "
          f"{errs['a']:.3g} and (b) kB {kb:.3g} {errs['b']:.3g}, {checks}; "
          f"max|diff| {k3p_abs!r}")
    del state, box_cases

    # -- K3's mechanics, fsi and solid-free paths, and K7 past cap 64: the
    # 3D FSI beam at nx=30 (cap 208) released and run, then with S seeded;
    # its fsi-style variant with seeded species; the Taylor-Green vortex at
    # N=20 (cap 86) run and jittered; K7 on both grids and on the beam's
    # main-size grid (nx=60, cap 296) after seeded seam drifts ---------------
    nf = FSI3D_NX[0]
    state, params, spec, _ = fsi.build_spanwise(
        nf, tdamp_solid=FSI3D_PARITY_RELEASE, device=dev)
    state = simulate(setup(state, params, spec, dt=1e-8), params, spec,
                     FSI3D_PARITY_STEPS)
    geom = spec.geom
    k3m_err, k3m_abs, ref = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, state, params, geom, spec.pair,
        k2_names, "K3 mechanics")
    seeded = _seed_beam_S(torch, state, seed=0)
    err_s, abs_s, ref_s = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, seeded, params, geom, spec.pair,
        k2_names, "K3 mechanics (seeded S)")
    k3m_abs = max(k3m_abs, abs_s)
    live = {"AS": float(pair._per_particle(seeded, params, spec.pair)["AS"]
                        .abs().max()),
            "dS run": float(ref["dS"].abs().max()),
            "dS seeded": float(ref_s["dS"].abs().max()),
            "ddx": float(ref_s["ddx"].abs().max()),
            "phi": float(ref_s["phi"].abs().max())}
    if not all(v > 0 for v in live.values()):
        raise AssertionError(f"K3 mechanics parity is vacuous: max|.| {live}")
    print(f"[K3 mechanics] 3D pass A kernel, mechanics pair style == plain "
          f"(3D FSI beam nx={nf}, {geom.ncells} cells, cap {geom.cap}, "
          f"periodic {geom.periodic}, {int(state.n_valid)} particles, step "
          f"{int(state.step)}, beam released at {FSI3D_PARITY_RELEASE}; both "
          f"filter variants), max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k3m_err.items())
          + f"; beam S seeded (max|.| {live}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in err_s.items())
          + f"; max|diff| {k3m_abs!r}")
    del seeded, ref, ref_s
    # K7 on the beam's grid: the run's state and a seeded seam drift
    drifted, across = _seam_drift(torch, state, geom, seed=8)
    k7l_what = []
    for label, st in (("run", state), ("seam drift", drifted)):
        what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                                 st, geom, _rebin_drop(spec),
                                 f"K7 large cap fsi3d nx={nf} {label}")
        k7l_what.append(f"3D FSI beam nx={nf} cap {geom.cap} {label}: {what}"
                        + (f", across {across}" if st is drifted else ""))
        k7l_abs = max(k7l_abs, err) if label != "run" else err
    del state, drifted

    # the fsi pair style on the 3D beam with seeded species (POLAR_CASES'
    # ranges, C up to 1.5), then 10 steps of it with one species
    state, params, spec, _ = fsi.build_spanwise(
        nf, tdamp_solid=FSI3D_PARITY_RELEASE, pair_style="fsi", kappa=1e-5,
        device=dev)
    state = simulate(setup(state, params, spec, dt=1e-8), params, spec,
                     FSI3D_PARITY_STEPS)
    geom = spec.geom
    k3f_err, k3f_abs = {}, 0.0
    for i, (label, ampl, coupling, advect, ns, cutc, c_hi) in enumerate(POLAR_CASES):
        if label not in FSI3D_CASES:
            continue
        s_, p_ = _seed_beam(torch, state, params, ns, seed=i, cutc_scale=cutc,
                            c_hi=c_hi)
        cfg = dataclasses.replace(spec.pair, ampl_damp=ampl,
                                  g0_chem_coupling=coupling,
                                  species_advection=advect)
        tag = f"K3 fsi {label}"
        err, err_abs, ref = _pass_a_parity(torch, pair, pair_cuda.pass_a_3d, s_,
                                           p_, geom, cfg, k2_names + ("Q",), tag)
        live = {"AS": float(pair._per_particle(s_, p_, cfg)["AS"].abs().max()),
                "dS": float(ref["dS"].abs().max()),
                "Q": float(ref["Q"].abs().amax(dim=(1, 2)).min())}
        if not all(v > 0 for v in live.values()):
            raise AssertionError(f"{tag} is vacuous: max|.| {live}")
        k3f_err[label] = (err["Q"], err["dS"], max(err.values()))
        k3f_abs = max(k3f_abs, err_abs)
    s_, p_ = _seed_beam(torch, state, params, 1, seed=0)
    for c in counters.values():
        c.launches = 0
    s_ = simulate(s_, p_, spec, 10)
    k3f_launches = pair_cuda.pass_a_3d.launches
    t_k3f = pass_a_timing(
        pair_cuda.pass_a_3d, s_, p_, geom,
        dataclasses.replace(spec.pair, density_filter_accs=False), 10,
        plain_iters=1)
    print(f"[K3 fsi] 3D pass A kernel, fsi pair style with species == plain, "
          f"every field, dS and Q (3D FSI beam nx={nf} with pair_style fsi, "
          f"cap {geom.cap}, step {int(state.step)}, beam S, v, rho and C "
          f"seeded, both filter variants); per case (max|diff|/max|ref| of Q, "
          f"of dS, of the worst field): "
          + ", ".join(f"{k} {v[0]:.3g} / {v[1]:.3g} ({v[2]:.3g})"
                      for k, v in k3f_err.items())
          + f"; max|diff| {k3f_abs!r}; 10 steps with one seeded species: K3 "
          f"launched {k3f_launches} times, per call ms {t_k3f['pass_a']!r} vs "
          f"plain pass A {t_k3f['pass_a_plain']!r}, bound "
          f"{t_k3f['pass_a_bound']} ({t_k3f['pass_a_work']}) [{card}]")
    del state, s_, p_, ref

    # the Taylor-Green vortex: solid-free, every axis periodic
    nt = TGV_N[0]
    state, params, spec, _ = taylor_green3d.build(nt, device=dev)
    state = simulate(setup(state, params, spec, dt=taylor_green3d.timestep(nt)),
                     params, spec, PARITY_STEPS["tgv"])
    geom = spec.geom
    # positions jittered by up to a tenth of a spacing (seed 6): on the
    # lattice ddv is a sum that cancels to a thousandth of its terms, which
    # f32 cannot resolve in any order of summation
    jittered = _jitter(torch, state, taylor_green3d.L / nt, seed=6)
    k3sf_err, k3sf_abs, ref = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, jittered, params, geom, spec.pair,
        k2_names, "K3 solid-free")
    got = pair_cuda.pass_a_3d(pair._per_particle(jittered, params, spec.pair),
                              params, geom, spec.pair)
    zero = {k: float(got[k].abs().max()) for k in ("phi", "nw", "dS", "ddx")}
    if any(zero.values()) or not float(ref["ddv"].abs().max()) > 0:
        raise AssertionError(f"K3 solid-free: phi, nw, dS and ddx must stay 0 "
                             f"({zero}) and ddv be live")
    print(f"[K3 solid-free] 3D pass A kernel, no solids == plain (Taylor-Green "
          f"vortex N={nt}, {geom.ncells} cells, cap {geom.cap}, periodic "
          f"{geom.periodic}, {int(state.n_valid)} particles, step "
          f"{int(state.step)}, x jittered by up to 0.1 spacing; both filter "
          f"variants), max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k3sf_err.items())
          + f"; phi, nw, dS and ddx exactly 0; max|diff| {k3sf_abs!r}")
    drifted, across = _seam_drift(torch, state, geom, seed=9)
    for label, st in (("run", state), ("seam drift", drifted)):
        what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                                 st, geom, _rebin_drop(spec),
                                 f"K7 large cap vortex N={nt} {label}")
        k7l_what.append(f"vortex N={nt} cap {geom.cap} {label}: {what}"
                        + (f", across {across}" if st is drifted else ""))
        k7l_abs = max(k7l_abs, err)
    del state, jittered, drifted, ref, got
    # the beam's main-size grid
    state, params, spec, _ = fsi.build_spanwise(FSI3D_NX[1], device=dev)
    state = setup(state, params, spec, dt=1e-8)
    geom = spec.geom
    drifted, across = _seam_drift(torch, state, geom, seed=10)
    what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                             drifted, geom, _rebin_drop(spec),
                             f"K7 large cap fsi3d nx={FSI3D_NX[1]}")
    k7l_what.append(f"3D FSI beam nx={FSI3D_NX[1]} cap {geom.cap} seam drift: "
                    f"{what}, across {across}")
    k7l_abs = max(k7l_abs, err)
    print(f"[K7 large cap] 3D rebin move kernel past cap 64 == plain walk == "
          f"sort rebin, bitwise: " + "; ".join(k7l_what))
    del state, drifted

    # -- K2 solid-free and K6 edges: the load-balance path's kernels --------
    sb = BLOB_S[1]
    state, params, spec, _ = drift_blob.build(sb, balance=True, inrun=True,
                                              device=dev)
    log = []
    state = simulate(setup(state, params, spec, dt=drift_blob.timestep(sb)),
                     params, spec, PARITY_STEPS["blob"], balance_log=log)
    geom = _current_geom(spec.geom, log)
    k2sf_err, k2sf_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_rowloop, state, params, geom,
        spec.pair, ("f", "drho", "de", "num_den", "ddv", "ddx", "phi", "nw",
                    "dS"), "K2 solid-free")
    # the run's pair terms vanish (rho 1, eta 0): a seeded density and
    # velocity (numpy, seed 0) make the force and drho terms live
    rng = np.random.default_rng(0)
    live = dataclasses.replace(
        state,
        rho=state.rho * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal(tuple(state.rho.shape)),
            dtype=state.rho.dtype, device=dev),
        v=state.v + torch.as_tensor(
            0.01 * rng.standard_normal(tuple(state.v.shape)),
            dtype=state.v.dtype, device=dev))
    err_l, abs_l, ref_l = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_rowloop, live, params, geom,
        spec.pair, ("f", "drho", "de", "num_den", "ddv", "ddx", "phi", "nw",
                    "dS"), "K2 solid-free (seeded rho, v)")
    k2sf_abs = max(k2sf_abs, abs_l)
    live_max = {k: float(ref_l[k].abs().max()) for k in ("f", "drho", "ddv")}
    if not all(live_max.values()):
        raise AssertionError(f"K2 solid-free parity is vacuous: {live_max}")
    print(f"[K2 solid-free] rowloop pass A kernel == plain (drifting blob "
          f"s={sb}, {int(state.n_valid)} particles, x_edges, periodic x, no "
          f"solids, cap {geom.cap}, {geom.ncells_total} cells, step "
          f"{int(state.step)}, re-cuts so far at steps "
          f"{[c['step'] for c in log if c['geom'] is not None]}), "
          f"max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k2sf_err.items())
          + f"; rho and v seeded (max|f| {live_max['f']:.3g}, max|drho| "
          f"{live_max['drho']:.3g}, max|ddv| {live_max['ddv']:.3g}): "
          + ", ".join(f"{k} {v:.3g}" for k, v in err_l.items())
          + f"; max|diff| {k2sf_abs!r}")
    k1sf_err, k1sf_abs = {}, 0.0
    sf_names = ("f", "drho", "de", "num_den", "ddv", "ddx", "phi", "nw", "dS")
    for label, s_ in (("as run", state), ("rho, v seeded", live)):
        err, err_abs, _ = _grouped_parity(
            torch, pair, pair_cuda, s_, params, geom, spec.pair, sf_names,
            f"K1 solid-free blob {label}")
        k1sf_err[f"blob s={sb} {label}"] = max(err.values())
        k1sf_abs = max(k1sf_abs, err_abs)
    del live, ref_l
    # a chunk later on the geometry the run ended on, without re-cuts
    spec = dataclasses.replace(spec, geom=geom, balance=None)
    state = simulate(state, params, spec, spec.rebin_every)
    drop = _rebin_drop(spec)
    what, k6e_abs = _move_parity(torch, S, rebin_cuda,
                                 rebin_cuda.rebin_move_2d_gated, state, geom,
                                 drop, "K6 edges")
    seam = _seeded_drift(torch, state, geom, seed=0)
    x0 = seam.x[0][seam.valid]
    across = int(((x0 < geom.lo[0]) | (x0 >= geom.hi[0])).sum())
    if across == 0:
        raise AssertionError("K6 edges: the seeded drift put no particle "
                             "across the periodic seam")
    what_s, err_s = _move_parity(torch, S, rebin_cuda,
                                 rebin_cuda.rebin_move_2d_gated, seam, geom,
                                 drop, "K6 edges (seeded drift)")
    k6e_abs = max(k6e_abs, err_s)
    print(f"[K6 edges] x_edges gated rebin move kernel == plain walk == sort "
          f"rebin, bitwise (drifting blob s={sb}, {geom.ncells[0]} x columns "
          f"of widths {float(min(np.diff(geom.x_edges)))!r}..."
          f"{float(max(np.diff(geom.x_edges)))!r}, periodic x, cap {geom.cap}, step "
          f"{int(state.step)}: {what}; after a seeded drift with {across} "
          f"particles across the seam: {what_s})")
    del state, seam

    # -- K2 and K6 on the polarization path: fsi pair style, species, both
    # axes periodic -----------------------------------------------------------
    nxp = POLAR_NX[0]
    state, params, spec, _ = cell_polarization.build(nx=nxp, device=dev)
    state = setup(state, params, spec, dt=POLAR_DT[nxp])
    geom = spec.geom
    k2p_names = k2_names + ("Q",)
    k2p_err, k2p_abs = {}, 0.0
    for when in (0, PARITY_STEPS["polarization"]):
        state = simulate(state, params, spec, when - int(state.step))
        cases = [(label, *_seed_polar(torch, state, params, ns, seed=i,
                                      cutc_scale=cutc, c_hi=c_hi),
                  dataclasses.replace(spec.pair, ampl_damp=ampl,
                                      g0_chem_coupling=coupling,
                                      species_advection=advect))
                 for i, (label, ampl, coupling, advect, ns, cutc, c_hi)
                 in enumerate(POLAR_CASES)]
        if when:  # the run's own S, C and velocities
            cases.insert(0, ("as run", state, params, spec.pair))
        k2p_err[when] = {}
        for label, s_, p_, cfg in cases:
            tag = f"K2 polarization step {when} {label}"
            err, err_abs, ref = _pass_a_parity(
                torch, pair, pair_cuda.pass_a_2d_rowloop, s_, p_, geom, cfg,
                k2p_names, tag)
            live = {"AS": float(pair._per_particle(s_, p_, cfg)["AS"].abs().max()),
                    "dS": float(ref["dS"].abs().max()),
                    "Q": float(ref["Q"].abs().amax(dim=(1, 2)).min())}
            if not all(v > 0 for v in live.values()):
                raise AssertionError(f"{tag} is vacuous: max|.| {live}")
            k2p_err[when][label] = (err["Q"], err["dS"], max(err.values()))
            k2p_abs = max(k2p_abs, err_abs)
    print(f"[K2 polarization] rowloop pass A kernel == plain, every field, dS "
          f"and Q (cell_polarization nx={nxp}, {int(state.n_valid)} particles, "
          f"cap {geom.cap}, {geom.ncells[:2]} cells, periodic {geom.periodic}, "
          f"both filter variants); per case (max|diff|/max|ref| of Q, of dS, of "
          f"the worst field): "
          + "; ".join(f"step {when}: " + ", ".join(
              f"{k} {v[0]:.3g} / {v[1]:.3g} ({v[2]:.3g})" for k, v in err.items())
              for when, err in k2p_err.items())
          + f"; max|diff| {k2p_abs!r}")
    for label, s_, p_, cfg in cases[:2]:
        err, err_abs, ref = _grouped_parity(
            torch, pair, pair_cuda, s_, p_, geom, cfg, k2p_names,
            f"K1 full body polarization {label}")
        live = {"dS": float(ref["dS"].abs().max()),
                "Q": float(ref["Q"].abs().max()),
                "ddx": float(ref["ddx"].abs().max())}
        if not all(v > 0 for v in live.values()):
            raise AssertionError(f"K1 full body polarization {label} is "
                                 f"vacuous: {live}")
        k1f_err[f"polarization nx={nxp} {label}"] = (max(err.values()), live)
        k1f_abs = max(k1f_abs, err_abs)
    # the crowded-cell grid of the JAX package's grouped-kernel test, which
    # JAX and the port route to the grouped kernel by default, then 10
    # steps of it through simulate (K1's solid-free launches)
    cs, cp, cgeom, ccfg = _crowded_grid(torch, S, pair, dev)
    if pair_cuda.route(cgeom, ccfg) is not pair_cuda.pass_a_2d:
        raise AssertionError("the crowded-cell grid does not route to K1")
    err, err_abs, _ = _grouped_parity(
        torch, pair, pair_cuda, cs, cp, cgeom, ccfg, sf_names,
        "K1 solid-free crowded cell")
    k1sf_err["crowded cell"] = max(err.values())
    k1sf_abs = max(k1sf_abs, err_abs)
    cspec = stepper_mod.ModelSpec(
        geom=cgeom, pair=ccfg,
        integ=stepper_mod.IntegratorConfig.transport_velocity())
    for c in counters.values():
        c.launches = 0
    cs = simulate(setup(cs, cp, cspec, dt=1e-4), cp, cspec, 10)
    k1sf_launches = {k: c.launches for k, c in counters.items() if c.launches}
    if k1sf_launches != {"pass_a_2d": 11, "rebin_move_2d": 2}:
        raise AssertionError(f"crowded-cell run: launch counts {k1sf_launches}")
    # K1 solid-free timed on the state its launches come from
    t_k1sf = pass_a_timing(pair_cuda.pass_a_2d, cs, cp, cgeom,
                           dataclasses.replace(ccfg, density_filter_accs=False),
                           10)
    print(f"[K1 full body] on the polarization state (fsi style, ampl_damp, "
          f"the G0 row, Ns=1, periodic {geom.periodic[:2]}, cap {geom.cap}) as "
          f"run and seeded, K4 == K1 bitwise: "
          + "; ".join(f"{k}: {v[0]:.3g} ({v[1]})" for k, v in k1f_err.items()
                      if k.startswith("polarization"))
          + f"; solid-free (phi, nw, dS exactly 0), K4 == K1 bitwise: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k1sf_err.items())
          + f"; the crowded-cell grid ({cgeom.ncells[:2]} cells of cap "
          f"{cgeom.cap}, base_occ {cgeom.base_occ}) through simulate(10): "
          f"launches {k1sf_launches}, then K1 {t_k1sf['pass_a']!r} ms per call "
          f"on its step-10 state vs plain {t_k1sf['pass_a_plain']!r}, bound "
          f"{t_k1sf['pass_a_bound']}; max|diff| full body {k1f_abs!r}, "
          f"solid-free {k1sf_abs!r}")
    del cases, ref, cs
    errs, err_abs, kb, checks = _thermal_rows(
        torch, pair, pair_cuda.pass_a_2d_rowloop, state, params, geom, spec.pair,
        k2p_names, "K2 thermal polarization")
    k2t[f"polarization nx={nxp} elastic Ns=1"] = (errs, kb, checks)
    k2t_abs = max(k2t_abs, err_abs)
    # 10 steps with the noise on (K2 every step), then K2 timed on that state
    spec_t = _noise_on(spec)
    for c in counters.values():
        c.launches = 0
    st = simulate(_noisy(torch, state), params, spec_t, 10)
    k2t_launches = pair_cuda.pass_a_2d_rowloop.launches
    t_k2t = pass_a_timing(
        pair_cuda.pass_a_2d_rowloop, st, params, geom,
        dataclasses.replace(spec_t.pair, density_filter_accs=False), 10)
    print(f"[K2 thermal] rowloop pass A kernel with the thermal rows == plain, "
          f"every field, both filter variants; per state the worst field's "
          f"max|diff|/max|ref| at (a) the SI kB and (b) the raised kB, and the "
          f"checks on (b): "
          + "; ".join(f"{k}: (a) {v[0]['a']:.3g}, (b) {v[0]['b']:.3g} at kB "
                      f"{v[1]:.3g}, {v[2]}" for k, v in k2t.items())
          + f"; max|diff| {k2t_abs!r}; 10 steps of the polarization with the "
          f"noise: K2 launched {k2t_launches} times, per call ms "
          f"{t_k2t['pass_a']!r} vs plain pass A {t_k2t['pass_a_plain']!r}, bound "
          f"{t_k2t['pass_a_bound']} [{card}]")
    del st
    drop = _rebin_drop(spec)
    state = simulate(state, params, spec, 50)  # since its last rebin
    what, k6p_abs = _move_parity(torch, S, rebin_cuda,
                                 rebin_cuda.rebin_move_2d_gated, state, geom,
                                 drop, "K6 periodic y")
    moved, across = _corner_drift(torch, state, geom, seed=0)
    if not all(across.values()):
        raise AssertionError(f"K6 periodic y: the seeded drift left a face or "
                             f"a corner uncrossed: {across}")
    what_d, err_d = _move_parity(torch, S, rebin_cuda,
                                 rebin_cuda.rebin_move_2d_gated, moved, geom,
                                 drop, "K6 periodic y (seeded drift)")
    k6p_abs = max(k6p_abs, err_d)
    print(f"[K6 periodic y] gated rebin move kernel == plain walk == sort "
          f"rebin, bitwise (cell_polarization nx={nxp}, {geom.ncells[:2]} cells, "
          f"periodic {geom.periodic}, cap {geom.cap}, step {int(state.step)}: "
          f"{what}; after a seeded drift with particles beyond the faces and "
          f"corners {across}: {what_d})")
    del state, moved

    # -- K5 on periodic grids: the doubly periodic 2D vortex ---------------
    nv = TGV2D_N
    state, params, spec, _ = taylor_green2d.build(nv, device=dev)
    geom = spec.geom
    if (rebin_cuda.move_route(geom) is not rebin_cuda.rebin_move_2d
            or pair_cuda.route(geom, spec.pair) is not pair_cuda.pass_a_2d_rowloop):
        raise AssertionError(f"the 2D vortex at N={nv} (cap {geom.cap}) does "
                             f"not route to K2 and K5")
    state = simulate(setup(state, params, spec,
                           dt=taylor_green2d.timestep(nv)), params, spec,
                     TGV2D_PARITY_STEPS)
    drop = _rebin_drop(spec)
    edged = _synthetic_edges(geom)
    k5p_abs, k5p_what = 0.0, []
    for g, st in ((geom, state), (edged, S.rebin(state, edged, drop=drop,
                                                 use_kernel=False,
                                                 drift_check=False))):
        for seed in range(64):  # the first drift that crosses them all
            moved, across = _corner_drift(torch, st, g, seed=seed)
            if all(across.values()):
                break
        else:
            raise AssertionError(f"K5 periodic: every seeded drift left a "
                                 f"face or a corner uncrossed: {across}")
        cols = "x_edges" if g.x_edges else "uniform"
        for label, s_ in (("as run", st), ("seeded drift", moved),
                          ("seam hairs", _seam_hairs(torch, st, g, seed=9))):
            what, err = _move_parity(torch, S, rebin_cuda,
                                     rebin_cuda.rebin_move_2d, s_, g, drop,
                                     f"K5 periodic {cols} {label}")
            k5p_abs = max(k5p_abs, err)
            k5p_what.append(f"{cols} {label}: {what}")
    print(f"[K5 periodic] rebin move kernel on both periodic axes == plain "
          f"walk == sort rebin, bitwise (2D Taylor-Green vortex N={nv}, "
          f"{geom.ncells[:2]} cells of cap {geom.cap}, step "
          f"{int(state.step)}; with uniform columns and with x columns of "
          f"widths 7/8 and 9/8 of a cell, as run, after a seeded drift "
          f"across every face and corner and with positions a hair below and "
          f"at the box's ends: {'; '.join(k5p_what)})")
    del state, moved, st, s_

    # -- K7 with x_edges on a periodic grid: the 3D drifting blob ----------
    sb3 = BLOB3D_S
    state, params, spec, _ = drift_blob.build(sb3, True, True, device=dev,
                                              nz_cells=BLOB3D_NZ)
    geom = spec.geom
    if (geom.x_edges is None or geom.periodic != (True, False, True)
            or rebin_cuda.move_route(geom) is not rebin_cuda.rebin_move_3d):
        raise AssertionError(f"the 3D blob s={sb3} is not an x_edges grid "
                             f"periodic in x and z routed to K7")
    state = simulate(setup(state, params, spec, dt=drift_blob.timestep(sb3)),
                     params, spec, spec.rebin_every)  # a chunk in
    drop = _rebin_drop(spec)
    what, k7ep_abs = _move_parity(torch, S, rebin_cuda,
                                  rebin_cuda.rebin_move_3d, state, geom, drop,
                                  "K7 edges periodic")
    moved, across = _edges_seam_drift(torch, state, geom, seed=0)
    what_d, err_d = _move_parity(torch, S, rebin_cuda,
                                 rebin_cuda.rebin_move_3d, moved, geom, drop,
                                 "K7 edges periodic (seam drift)")
    k7ep_abs = max(k7ep_abs, err_d)
    print(f"[K7 edges periodic] 3D rebin move kernel with x_edges on a grid "
          f"periodic in x and z == plain walk == sort rebin, bitwise (3D "
          f"drifting blob s={sb3}, {geom.ncells} cells of cap {geom.cap}, x "
          f"columns of {min(np.diff(geom.x_edges)) / geom.x_quantum:.0f}-"
          f"{max(np.diff(geom.x_edges)) / geom.x_quantum:.0f} quanta, step "
          f"{int(state.step)}: {what}; after a seeded drift across the x "
          f"and z seams {across}: {what_d})")
    del state, moved

    # -- K8: the window-rotation probe through its entry point -------------
    torch.backends.cuda.matmul.allow_tf32 = False  # the matmul's yardstick
    probe_tool = _load_tool("torch_rotation_probe")
    k8_names = ("probe_slice", "probe_mma", "probe_base")
    for name in k8_names:
        counters[name].launches = 0
    probe_out = probe_tool.run(rp.BLOCKS, PROBE_REPEATS, dev)
    k8_launches = {name: counters[name].launches for name in k8_names}
    if min(k8_launches.values()) == 0 or not probe_out["mma_bit_identical"]:
        raise AssertionError(f"[K8] the probe's run: launches {k8_launches}, "
                             f"mma bitwise slice {probe_out['mma_bit_identical']}")
    xw, shift = probe_tool.window(dev), rp.shift_matrix(dev)
    g8 = rp.BLOCKS
    k8 = {}
    for variant in rp.VARIANTS:
        got = rp.probe(variant, xw, g8, shift)
        ref = rp.plain(variant, xw, g8, shift)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"[K8] {variant} != its plain version: "
                                 f"max|diff| {float((got - ref).abs().max())!r}")
        k8[variant] = {
            "err": float((got - ref).abs().max()),
            "ms": probe_out[f"{variant}_ms"],
            "plain": _per_call_ms(
                torch, lambda v=variant: rp.plain(v, xw, g8, shift), 20)}
    if not torch.equal(rp.probe_mma(xw, shift, g8), rp.probe_slice(xw, g8)):
        raise AssertionError("[K8] mma != slice")
    # bounds: slice and base read x once and write the output once; mma also
    # reads S, and does 3 x R x W x 9 BLK multiply-adds a block (the three
    # TF32 parts) at the dense TF32 rate
    out_bytes = 4 * rp.R * rp.BLK * g8
    k8_bytes = {"slice": 4 * rp.R * rp.W + out_bytes,
                "base": 4 * rp.R * rp.W + out_bytes,
                "mma": 4 * (rp.R * rp.W + rp.W * 9 * rp.BLK) + out_bytes}
    mma_flops = 2 * 3 * rp.R * rp.W * 9 * rp.BLK * g8
    for variant in rp.VARIANTS:
        t_b = k8_bytes[variant] / PEAK_BYTES
        t_o = mma_flops / PEAK_TF32 if variant == "mma" else 0.0
        k8[variant]["bound"] = (max(t_b, t_o) * 1e3,
                                "bytes" if t_b >= t_o else "operations")
    print(f"[K8] window-rotation probe (tools/torch_rotation_probe.py, "
          f"{g8} blocks of the [{rp.R}, {rp.W}] window, {PROBE_REPEATS} calls "
          f"a timed run), each kernel == its plain version bitwise, mma == "
          f"slice bitwise: launches {k8_launches}; per call ms slice "
          f"{k8['slice']['ms']!r}, mma {k8['mma']['ms']!r}, base "
          f"{k8['base']['ms']!r}, its {g8} products in one call "
          f"(torch.matmul(x.expand(g, R, W), S)) at f32 with TF32 off "
          f"{probe_out['matmul_ms']!r}; plain versions "
          + ", ".join(f"{v} {k8[v]['plain']!r}" for v in rp.VARIANTS)
          + "; bounds " + ", ".join(f"{v} {k8[v]['bound']}" for v in rp.VARIANTS)
          + f"; rotation cost (slice - base) {probe_out['rotation_cost_ms']!r}, "
          f"mma cost (mma - base) {probe_out['mma_cost_ms']!r} ms [{card}]")
    del xw, shift

    # -- 9. main paths ------------------------------------------------------
    def run_main(build, dt, want_kernels, steps, make_callback=None, **sim_kw):
        """build -> setup -> simulate(steps) with the launch counters reset
        first (``make_callback(params, spec)``: simulate's callback)."""
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        run_main.built = build()
        state, params, spec, _ = run_main.built
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n0 = int(state.n_valid)
        if make_callback is not None:
            sim_kw["callback"] = make_callback(params, spec)
        state = simulate(setup(state, params, spec, dt=dt), params, spec, steps,
                         **sim_kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        want = dict.fromkeys(counters, 0)
        want[want_kernels[0]] = steps + 1  # every step plus setup
        want[want_kernels[1]] = -(-steps // spec.rebin_every) + 1  # chunks
        if launches != want:
            raise AssertionError(f"launch counts {launches}, expected {want}")
        valid = state.valid
        checks = {
            "finite": all(bool(torch.isfinite(getattr(state, n)).all())
                          for n in ("x", "v", "vest", "rho", "f", "S", "dS")),
            "overflow 0": int(state.overflow) == 0,
            "drift_violation 0": int(state.drift_violation) == 0,
            "particles conserved": int(state.n_valid) == n0,
            "step": int(state.step) == steps,
        }
        vmax = float(torch.sqrt((state.v * state.v).sum(0))[valid].max())
        return state, spec, n0, (build_s, secs), launches, vmax, checks

    def require(checks, tag, detail):
        if not all(checks.values()):
            raise AssertionError(f"{tag} invariants failed: {checks}; {detail}")

    # the cavity
    state, spec, n0, secs, cav_launches, vmax, checks = run_main(
        lambda: lid_cavity.build(N=CAVITY_N[0], device=dev), 1e-4,
        ("pass_a_2d", "rebin_move_2d"), MAIN_STEPS["cavity"])
    fluid = state.valid & (state.solid_tag == 0)
    rho_dev = float((state.rho[fluid] - 1.0).abs().max())
    rho_mean = float(state.rho[fluid].mean())
    # the JAX package's own N=200 run reaches max|rho-1| 0.021 by step 400
    # and 0.023 by step 700 (lid-corner pressure), so the bound on the
    # extreme is 0.05; the mean must stay within 0.2% of 1
    checks.update({"max|v| <= 1.1": vmax <= 1.1,
                   "fluid max|rho-1| <= 0.05": rho_dev <= 0.05,
                   "fluid |mean rho-1| <= 0.002": abs(rho_mean - 1.0) <= 0.002})
    detail = (f"max|v| {vmax!r}, fluid max|rho-1| {rho_dev!r}, fluid mean "
              f"rho {rho_mean!r}")
    require(checks, "cavity main path", detail)
    print(f"[main] cavity N={CAVITY_N[0]} build+setup+simulate("
          f"{MAIN_STEPS['cavity']}) in {secs[1]!r} s (build {secs[0]!r} s): "
          f"{n0} particles, {detail}, launches {cav_launches}")

    # -- the grouped kernel's main paths: the flagship at GROUPED_N through
    # K4 (preshift_window), then the same run through K1; the cavity under
    # the mechanics pair style through K1's full body; against the JAX run
    Ng = GROUPED_N

    def cavity_build(N, **kw):
        """lid_cavity.scene(N=N, **kw) built on the card."""
        sc = lid_cavity.scene(Scene, Region, SetForce, N=N, **kw)
        return (*sc.build(device=dev), sc)

    def k1_k4_timing(tag, state, params, geom, cfg, launches):
        """K1 and K4 per call on one state (CUDA events; the plain loop
        once), their device ms per call (torch.profiler) and bounds (their
        tile from ``pair_cuda.k4_tile`` at the window's depth, the grid's
        largest tail)."""
        cfg = dataclasses.replace(cfg, density_filter_accs=False)
        t = {}
        # K1 and K4 launch one kernel (csrc/pass_a_2d.cuh), each timed in
        # its own window
        for name, kernel, match in (("K1", pair_cuda.pass_a_2d, "pa2d::window_"),
                                    ("K4", pair_cuda.pass_a_2d_preshift,
                                     "pa2d::window_")):
            t[name] = pass_a_timing(kernel, state, params, geom, cfg, 10,
                                    plain_iters=1)
            pf = pair._per_particle(state, params, cfg)
            t[name]["device_ms"], _ = _kernel_device_ms(
                torch, lambda: kernel(pf, params, geom, cfg), match, 10)
        depth = pair_cuda.tail_index(state.valid)[1]
        tile = pair_cuda.k4_tile(t["K4"]["pass_a_rows"], depth,
                                 pair_cuda.tv_body(geom, cfg))
        for name in ("K1", "K4"):
            tt = t[name]
            print(f"[speed] {tag}: {name} {tt['pass_a']!r} ms per call as called "
                  f"(CUDA events, packing included; tile {tile}, window "
                  f"{depth} of cap {geom.cap} slots deep), launches on "
                  f"its main path {launches[name]}, bound {tt['pass_a_bound']} "
                  f"({tt['pass_a_work']}), plain pass A {tt['pass_a_plain']!r} "
                  f"[{card}]")
            print(f"[profile] {tag}: {name} {tt['device_ms']!r} ms of device "
                  f"time per call (torch.profiler, 10 calls) [{card}]")
        return t

    state, spec, n0, secs, pre_launches, vmax, checks = run_main(
        lambda: cavity_build(Ng, preshift_window=True), GROUPED_DT,
        ("pass_a_2d_preshift", "rebin_move_2d"), GROUPED_STEPS)
    params = run_main.built[1]
    require(checks, "preshift main path", f"max|v| {vmax!r}")
    s_k1, p_k1, spec_k1, _ = cavity_build(Ng)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    via_k1 = simulate(setup(s_k1, p_k1, spec_k1, dt=GROUPED_DT), p_k1, spec_k1,
                      GROUPED_STEPS)
    torch.cuda.synchronize()
    k1_secs = time.perf_counter() - t0
    k1_launches = {k: c.launches for k, c in counters.items() if c.launches}
    if k1_launches != {"pass_a_2d": GROUPED_STEPS + 1,
                       "rebin_move_2d": pre_launches["rebin_move_2d"]}:
        raise AssertionError(f"the K1 run: launch counts {k1_launches}")
    differ = [f.name for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)
              and not torch.equal(getattr(state, f.name), getattr(via_k1, f.name))]
    if differ:
        raise AssertionError(f"[main preshift] the K4 run's step-{GROUPED_STEPS} "
                             f"state differs from the K1 run's in {differ}")
    del via_k1, s_k1
    k4_err, k4_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_preshift, state, params, spec.geom,
        spec.pair, k1_names, "K4 main preshift")
    fluid = state.valid & (state.solid_tag == 0)
    print(f"[main preshift] lid_cavity.scene(N={Ng}, preshift_window=True) "
          f"build+setup+simulate({GROUPED_STEPS}) in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, cap {spec.geom.cap}, "
          f"{spec.geom.ncells_total} cells, launches {pre_launches}; the same "
          f"run through K1 in {k1_secs!r} s, launches {k1_launches}: the "
          f"step-{GROUPED_STEPS} states bitwise equal, every field; K4 == plain "
          f"on that state, max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k4_err.items())
          + f"; max|v| {vmax!r}, fluid max|rho-1| "
          f"{float((state.rho[fluid] - 1.0).abs().max())!r} [{card}]")
    t_pre = k1_k4_timing(f"flagship N={Ng} step {GROUPED_STEPS}", state, params,
                         spec.geom, spec.pair,
                         {"K1": k1_launches["pass_a_2d"],
                          "K4": pre_launches["pass_a_2d_preshift"]})
    del state

    state, spec, n0, secs, mech_launches, vmax, checks = run_main(
        lambda: cavity_build(Ng, pair_style="mechanics"), GROUPED_DT,
        ("pass_a_2d", "rebin_move_2d"), GROUPED_STEPS)
    params = run_main.built[1]
    fluid = state.valid & (state.solid_tag == 0)
    rho_dev = float((state.rho[fluid] - 1.0).abs().max())
    rho_mean = float(state.rho[fluid].double().mean())
    ref_dev, lo, hi = MECH_PLAIN_RHO1000
    checks.update({"max|v| <= 1.1": vmax <= 1.1,
                   f"fluid max|rho-1| in [{lo}, {hi}] x the plain loop's "
                   f"{ref_dev}": lo * ref_dev <= rho_dev <= hi * ref_dev,
                   "fluid |mean rho-1| <= 0.002": abs(rho_mean - 1.0) <= 0.002,
                   "full body": not pair_cuda.tv_body(spec.geom, spec.pair)})
    detail = (f"max|v| {vmax!r}, fluid max|rho-1| {rho_dev!r}, fluid mean rho "
              f"{rho_mean!r}")
    require(checks, "mechanics main path", detail)
    k1m_err, k1m_abs, ref = _grouped_parity(
        torch, pair, pair_cuda, state, params, spec.geom, spec.pair,
        k1_names + ("ddx",), "K1 main mechanics")
    ddx_max = float(ref["ddx"].abs().max())
    if not ddx_max > 0:
        raise AssertionError("K1 main mechanics: ddx is 0")
    del ref
    # the same scene with preshift_window: K4's own main path, its
    # step-GROUPED_STEPS state bitwise the K1 run's
    via_k4, _, _, k4m_secs, k4m_launches, _, k4m_checks = run_main(
        lambda: cavity_build(Ng, pair_style="mechanics", preshift_window=True),
        GROUPED_DT, ("pass_a_2d_preshift", "rebin_move_2d"), GROUPED_STEPS)
    require(k4m_checks, "mechanics main path through K4", "")
    differ = [f.name for f in dataclasses.fields(state)
              if isinstance(getattr(state, f.name), torch.Tensor)
              and not torch.equal(getattr(state, f.name), getattr(via_k4, f.name))]
    if differ:
        raise AssertionError(f"[main mechanics] the K4 run's step-{GROUPED_STEPS} "
                             f"state differs from the K1 run's in {differ}")
    del via_k4
    print(f"[main mechanics] lid_cavity.scene(N={Ng}, pair_style=\"mechanics\") "
          f"build+setup+simulate({GROUPED_STEPS}) in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, {detail}, launches {mech_launches} "
          f"(K1's full body); K1 == plain on the step-{GROUPED_STEPS} state, "
          f"K4 == K1 bitwise, max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k1m_err.items())
          + f" (max|ddx| {ddx_max:.3g}); with preshift_window=True the same "
          f"run in {k4m_secs[1]!r} s, launches {k4m_launches}: the "
          f"step-{GROUPED_STEPS} states bitwise equal, every field [{card}]")
    t_mech = k1_k4_timing(f"mechanics cavity N={Ng} step {GROUPED_STEPS}", state,
                          params, spec.geom, spec.pair,
                          {"K1": mech_launches["pass_a_2d"],
                           "K4": k4m_launches["pass_a_2d_preshift"]})
    del state

    for nj, (dtj, bands) in MECH_JAX.items():
        state, spec, n0, secs, mj_launches, vmax, checks = run_main(
            lambda: cavity_build(nj, pair_style="mechanics"), dtj,
            ("pass_a_2d", "rebin_move_2d"), MECH_JAX_STEPS)
        params = run_main.built[1]
        fluid = state.valid & (state.solid_tag == 0)
        energy = _cavity_energy(torch, state, params)
        got = {"fluid max|v|": energy["fluid max|v|"],
               "fluid ke": energy["fluid ke"],
               "fluid mean rho": float(state.rho[fluid].double().mean()),
               "fluid max|rho-1|": float((state.rho[fluid] - 1.0).abs().max())}
        for name, (ref_v, lo, hi) in bands.items():
            checks[f"{name} in [{lo}, {hi}] x JAX's {ref_v}"] = \
                lo * ref_v <= got[name] <= hi * ref_v
        require(checks, f"mechanics N={nj} vs JAX", f"{got}")
        print(f"[main mechanics vs JAX] mechanics cavity N={nj}, "
              f"{MECH_JAX_STEPS} steps on the card in {secs[1]!r} s: {got} "
              f"inside the bands {bands} around the JAX package's own run, "
              f"launches {mj_launches} [{card}]")
        del state

    # natural convection around the hot cylinder, at the reference's size
    state, spec, n0, secs, conv_launches, vmax, checks = run_main(
        lambda: natural_convection.build(N=CONV_N[0], device=dev),
        CONV_DT[CONV_N[0]], ("pass_a_2d", "rebin_move_2d"),
        MAIN_STEPS["convection"])
    def convection_gates(state, vmax, n0, checks, bands):
        """The convection main path's checks on its final state: particles
        kept, C and Q finite, 0 <= C <= C0, the Dirichlet values held one
        half step on, qdot > 0, and max|v|, qdot and the fluid's mean C
        inside ``bands`` around the JAX package's own run.  Returns (the
        banded values, a description)."""
        params, scene = run_main.built[1], run_main.built[3]
        C, C0 = state.C[0], 1.0
        fluid = state.valid & (state.solid_tag == 0)
        in_group = lambda name: state.valid & (
            (state.groupmask & scene.groupbit(name)) != 0)
        # the Dirichlet forcing clamps C after the first half step; the
        # second half step then adds Q dt/2, so at a step's end a clamped
        # particle holds exactly max(value + Q dt/2, 0)
        held = lambda name, value: bool((C[in_group(name)] == torch.clamp_min(
            value + state.Q[0] * (0.5 * state.dt), 0.0)[in_group(name)]).all())
        got = {"max|v|": vmax,
               "qdot": natural_convection.qdot(state, params,
                                               scene.groupbit("sphere")),
               "fluid mean C": float(C[fluid].double().mean())}
        checks.update({
            f"{CONV_PARTICLES} particles": n0 == CONV_PARTICLES,
            "C and Q finite": bool(torch.isfinite(state.C).all()
                                   and torch.isfinite(state.Q).all()),
            "0 <= C <= C0": bool(((C >= 0.0) & (C <= C0))[state.valid].all()),
            "walls held at C = 0": held("walls", 0.0),
            "cylinder held at C = C0": held("sphere", C0),
            "qdot > 0": got["qdot"] > 0.0,
        })
        for name, (ref, lo, hi) in bands.items():
            checks[f"{name} in [{lo}, {hi}] x JAX's {ref}"] = \
                lo * ref <= got[name] <= hi * ref
        return got, (", ".join(f"{k} {v!r}" for k, v in got.items())
                     + f", fluid max C {float(C[fluid].max())!r}, fluid "
                     f"max|rho-1| {float((state.rho[fluid] - 1.0).abs().max())!r}")

    conv_got, detail = convection_gates(state, vmax, n0, checks,
                                        CONV_JAX_STEP1000)
    require(checks, "convection main path", detail)
    print(f"[main convection] natural_convection N={CONV_N[0]} build+setup+"
          f"simulate({MAIN_STEPS['convection']}) in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, cap {spec.geom.cap}, "
          f"{spec.geom.ncells_total} cells, {detail} (bands "
          f"{CONV_JAX_STEP1000}), launches {conv_launches} [{card}]")
    del state

    # the reference's own configuration: natural convection with the SDPD
    # noise at the SI kB and the model's e = 1e-6, the thermo table of its
    # script every 100 steps
    thermo_logs = []

    def thermo(params, spec):
        logger = ThermoLogger(params, every=THERMO_EVERY,
                              columns=("step", "dt", "press", "temp", "etotal"),
                              geom=spec.geom, pair_cfg=spec.pair)
        thermo_logs.append(logger)
        return logger

    state, spec, n0, secs, th_launches, vmax, checks = run_main(
        lambda: _with_noise(natural_convection.build(N=CONV_N[0], device=dev)),
        CONV_DT[CONV_N[0]], ("pass_a_2d", "rebin_move_2d"),
        MAIN_STEPS["convection"], make_callback=thermo,
        callback_every=THERMO_EVERY)
    rows = thermo_logs[-1].history
    checks.update({
        "thermal pair style": spec.pair.thermal,
        "SI kB, e = 1e-6": run_main.built[1].boltz == 1.3806504e-23 and float(
            state.e[state.valid].max()) == float(state.e[state.valid].min())
        == float(torch.tensor(1e-6, dtype=state.e.dtype)),
        f"a thermo row every {THERMO_EVERY} steps": [r["step"] for r in rows]
        == list(range(THERMO_EVERY, MAIN_STEPS["convection"] + 1, THERMO_EVERY)),
        "press, temp, etotal finite": all(
            np.isfinite([r["press"], r["temp"], r["etotal"]]).all() for r in rows),
    })
    th_got, detail = convection_gates(state, vmax, n0, checks,
                                      CONV_THERMAL_JAX_STEP1000)
    require(checks, "thermal convection main path", detail)
    gap_jax = {k: th_got[k] / CONV_JAX_STEP1000[k][0] - 1.0 for k in th_got}
    gap_card = {k: th_got[k] / conv_got[k] - 1.0 for k in th_got}
    print(f"[main thermal] natural_convection N={CONV_N[0]} with thermal=True "
          f"(kB {run_main.built[1].boltz!r}, e 1e-6) build+setup+simulate("
          f"{MAIN_STEPS['convection']}) with ThermoLogger(every={THERMO_EVERY}, "
          f"step dt press temp etotal) in {secs[1]!r} s (build {secs[0]!r} s): "
          f"{n0} particles, {detail} (bands {CONV_THERMAL_JAX_STEP1000}); "
          f"relative gap to the thermal-off run: JAX's constants {gap_jax}, "
          f"this card's {gap_card}; thermo rows {len(rows)}, the last "
          f"{ {k: rows[-1][k] for k in ('step', 'dt', 'press', 'temp', 'etotal')} }; "
          f"launches {th_launches} [{card}]")
    del state

    # the flagship cavity with the noise made visible, against the JAX
    # package's own run, and beside the same run without the noise
    visible = {}
    for thermal in (True, False):
        state, spec, n0, secs, launches, vmax, checks = run_main(
            lambda thermal=thermal: _visible_cavity(CAVITY_N[0], dev, thermal),
            1e-4, ("pass_a_2d", "rebin_move_2d"), VISIBLE_STEPS)
        params = run_main.built[1]
        visible[thermal] = got = _cavity_energy(torch, state, params)
        if thermal:
            for name, (ref, lo, hi) in CAVITY_VISIBLE_JAX_STEP200.items():
                checks[f"{name} in [{lo}, {hi}] x JAX's {ref}"] = \
                    lo * ref <= got[name] <= hi * ref
            vis_launches, vis_secs = launches, secs
        require(checks, f"visible-noise cavity (thermal {thermal})",
                f"{got}")
        del state
    # the noise must move the fluid by more than the bands allow
    moved = visible[True]["fluid ke"] / visible[False]["fluid ke"] - 1.0
    if not abs(moved) > 0.1:
        raise AssertionError(f"the visible noise changed the fluid's kinetic "
                             f"energy by only {moved!r}: {visible}")
    print(f"[main thermal visible] lid_cavity N={CAVITY_N[0]} with thermal=True,"
          f" e 1 and kB {VISIBLE_KBE!r}, build+setup+simulate({VISIBLE_STEPS}) in "
          f"{vis_secs[1]!r} s: {visible[True]} (bands "
          f"{CAVITY_VISIBLE_JAX_STEP200}); without the noise {visible[False]} "
          f"(fluid kinetic energy {moved:+.3g} with it); launches "
          f"{vis_launches} [{card}]")

    # cell polarization at the reference's size
    state, spec, n0, secs, polar_launches, vmax, checks = run_main(
        lambda: cell_polarization.build(nx=POLAR_NX[0], device=dev),
        POLAR_DT[POLAR_NX[0]], ("pass_a_2d_rowloop", "rebin_move_2d_gated"),
        MAIN_STEPS["polarization"])
    scene = run_main.built[3]
    C = state.C[0]
    wall = state.valid & (state.solid_tag == 1)
    lower = state.valid & (
        (state.groupmask & scene.groupbit("lowerhalfcircle")) != 0)
    speed_p = torch.sqrt((state.v * state.v).sum(0))
    got = {"max|v|": vmax,
           "wall max|v|": float(speed_p[wall].max()),
           "wall mean C": float(C[wall].double().mean()),
           "max|S|": float(state.S.abs().max())}
    checks.update({
        f"{POLAR_PARTICLES} particles": n0 == POLAR_PARTICLES,
        "C and Q finite": bool(torch.isfinite(state.C).all()
                               and torch.isfinite(state.Q).all()),
        "0 <= C <= 1": bool(((C >= 0.0) & (C <= 1.0))[state.valid].all()),
        # the forcing clamps C after the first half step; the second half
        # step then adds Q dt/2
        "lower wall held at C = 1": int(lower.sum()) > 0 and bool(
            (C[lower] == torch.clamp_min(
                1.0 + state.Q[0] * (0.5 * state.dt), 0.0)[lower]).all()),
        "species in the neighbours": float(C[state.valid & ~lower].max()) > 0.0,
        "the wall moves (released at step 2)": got["wall max|v|"] > 0.0,
    })
    for name, (ref, lo, hi) in POLAR_JAX_STEP1000.items():
        checks[f"{name} in [{lo}, {hi}] x JAX's {ref}"] = lo * ref <= got[name] <= hi * ref
    detail = (", ".join(f"{k} {v!r}" for k, v in got.items())
              + f", max C off the lower wall "
              f"{float(C[state.valid & ~lower].max())!r}, lower wall C "
              f"{float(C[lower].min())!r}..{float(C[lower].max())!r}")
    require(checks, "polarization main path", detail)
    print(f"[main polarization] cell_polarization nx={POLAR_NX[0]} build+setup+"
          f"simulate({MAIN_STEPS['polarization']}) at dt "
          f"{POLAR_DT[POLAR_NX[0]]} in {secs[1]!r} s (build {secs[0]!r} s): {n0} "
          f"particles, cap {spec.geom.cap}, {spec.geom.ncells[:2]} cells, "
          f"periodic {spec.geom.periodic}, {int(wall.sum())} wall particles "
          f"({int(lower.sum())} clamped), {detail} (bands "
          f"{POLAR_JAX_STEP1000}), launches {polar_launches} [{card}]")
    del state, C

    # the FSI beam, released half way
    state, spec, n0, secs, fsi_launches, vmax, checks = run_main(
        lambda: fsi.build(nx=FSI_NX[0], tdamp_solid=FSI_RELEASE["main"],
                          device=dev), 1e-8,
        ("pass_a_2d_rowloop", "rebin_move_2d_gated"), MAIN_STEPS["fsi"])
    valid = state.valid
    solid = state.solid_tag == 1
    fluid = valid & ~solid
    beam = valid & solid & (state.fixed_tag == 0)
    got = {"max|v|": vmax,
           "fluid max|rho/1000-1|": float((state.rho[fluid] / 1000.0 - 1.0)
                                          .abs().max()),
           "fluid mean rho": float(state.rho[fluid].mean()),
           "beam max|v|": float(torch.sqrt((state.v * state.v).sum(0))[beam].max()),
           "beam max|S|": float(state.S.abs().amax(dim=(0, 1))[beam].max())}
    for name, (ref, lo, hi) in FSI_JAX_STEP1000.items():
        checks[f"{name} in [{lo}, {hi}] x JAX's {ref}"] = lo * ref <= got[name] <= hi * ref
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, "FSI main path", detail)
    print(f"[main] fsi nx={FSI_NX[0]} build+setup+simulate({MAIN_STEPS['fsi']}) "
          f"in {secs[1]!r} s (build {secs[0]!r} s): {n0} particles, {detail}, "
          f"launches {fsi_launches}")
    del state

    # the 3D cavity at 1.19M particles
    N3 = CAVITY3D_N[1]
    state, spec, n0, secs, c3_launches, vmax, checks = run_main(
        lambda: lid_cavity3d.build(N=N3, device=dev), 1e-4,
        ("pass_a_3d", "rebin_move_3d"), MAIN_STEPS["cavity3d"])
    fluid = state.valid & (state.solid_tag == 0)
    rho_mean = float(state.rho[fluid].mean())
    vx_max = float(state.v[0][fluid].max())
    checks.update({"max|v| <= 1.1": vmax <= 1.1,
                   "fluid |mean rho-1| <= 0.002": abs(rho_mean - 1.0) <= 0.002,
                   "fluid max v_x > 1e-3": vx_max > 1e-3})
    detail = (f"max|v| {vmax!r}, fluid max|rho-1| "
              f"{float((state.rho[fluid] - 1.0).abs().max())!r}, fluid mean rho "
              f"{rho_mean!r}, fluid max v_x {vx_max!r}")
    require(checks, "3D cavity main path", detail)
    print(f"[main] lid_cavity3d N={N3} build+setup+simulate("
          f"{MAIN_STEPS['cavity3d']}) in {secs[1]!r} s (build {secs[0]!r} s): "
          f"{n0} particles, cap {spec.geom.cap}, {spec.geom.ncells_total} cells, "
          f"{detail}, launches {c3_launches}")
    del state

    # the 3D cavity at N=20 against the JAX package's own run
    Nj = CAVITY3D_JAX_N
    state, params, spec, _ = lid_cavity3d.build(N=Nj, device=dev)
    state = simulate(setup(state, params, spec, dt=1e-4), params, spec,
                     CAVITY3D_JAX_STEPS)
    fluid = state.valid & (state.solid_tag == 0)
    top = fluid & (state.x[2] > 1.0 - 1.0 / Nj)
    speed3 = torch.sqrt((state.v * state.v).sum(0))
    got = {"fluid max|v|": float(speed3[fluid].max()),
           "fluid max|rho-1|": float((state.rho[fluid] - 1.0).abs().max()),
           "fluid mean rho": float(state.rho[fluid].mean()),
           "top fluid mean v_x": float(state.v[0][top].mean())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in CAVITY3D_JAX_STEP200.items()}
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, f"3D cavity N={Nj} vs JAX", detail)
    print(f"[main] lid_cavity3d N={Nj}, {CAVITY3D_JAX_STEPS} steps on the card "
          f"vs the JAX package's own run: {detail} (bands {CAVITY3D_JAX_STEP200})")
    del state

    # the spanwise-periodic cavity at 1,123,600 particles, with a Restart
    # checkpoint and a VTK frame (the rho and p computes) every SPAN_EVERY
    # steps, written under the checkout's build/ and removed at the end;
    # every rebin is counted, so a sort rebin after the build would show
    Nsp = SPAN_N[1]
    span_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_spanwise"
    shutil.rmtree(span_dir, ignore_errors=True)
    span_dir.mkdir(parents=True)
    frames, rebins, vy_trace = [], [], []

    def span_callback(params, spec):
        restart = checkpoint.Restart(SPAN_EVERY, str(span_dir / "restart_{step}.npz"),
                                     spec.geom)

        def callback(state):
            """Every SPAN_TRACE steps max|v_y| / max|v| and the fluid's
            max|rho-1|; every SPAN_EVERY steps a checkpoint and a frame."""
            step = int(state.step)
            fluid = state.valid & (state.solid_tag == 0)
            speed = torch.sqrt((state.v * state.v).sum(0))[state.valid]
            vy_trace.append((step, float(state.v[1][state.valid].abs().max()
                                         / speed.max()),
                             float((state.rho[fluid] - 1.0).abs().max())))
            if step % SPAN_EVERY:
                return
            t0 = time.perf_counter()
            restart(state)
            t1 = time.perf_counter()
            path = span_dir / f"frame_{step}.vtk"
            n = _write_frame(S, computes, vtk, path, state, spec.geom)
            frames.append((path, n, t1 - t0, time.perf_counter() - t1))
        return callback

    real_rebin = stepper_mod.rebin

    def counted_rebin(state, geom, drop=(), use_kernel=True, drift_check=True):
        rebins.append(use_kernel and drift_check and rebin_cuda.move_supported(geom))
        return real_rebin(state, geom, drop, use_kernel, drift_check)

    stepper_mod.rebin = counted_rebin
    try:
        state, spec, n0, secs, span_launches, vmax, checks = run_main(
            lambda: lid_cavity3d.build_spanwise(Nsp, device=dev), 1e-4,
            ("pass_a_3d", "rebin_move_3d"), SPAN_STEPS, span_callback,
            callback_every=SPAN_TRACE)
    finally:
        stepper_mod.rebin = real_rebin
    params = run_main.built[1]
    geom = spec.geom
    valid = state.valid
    fluid = valid & (state.solid_tag == 0)
    speed_sp = torch.sqrt((state.v * state.v).sum(0))
    vy_ratio = float(state.v[1][valid].abs().max()) / vmax
    rho_mean = float(state.rho[fluid].mean())
    rho_dev = float((state.rho[fluid] - 1.0).abs().max())
    reads = []
    for path, n, ck_s, frame_s in frames:
        t0 = time.perf_counter()
        points, data = vtk.read_vtk(str(path))
        reads.append((path.name, points.shape[0], n, sorted(data), ck_s, frame_s,
                      time.perf_counter() - t0,
                      bool(np.isfinite(points).all()
                           and all(np.isfinite(a).all() for a in data.values()))))
    checks.update({
        f"{SPAN_PARTICLES[Nsp]} particles": n0 == SPAN_PARTICLES[Nsp],
        "y periodic": geom.periodic == (False, True, False),
        "max|v| <= 1.05": vmax <= 1.05,
        "fluid |mean rho-1| <= 0.002": abs(rho_mean - 1.0) <= 0.002,
        "fluid max|rho-1| <= 0.05": rho_dev <= 0.05,
        f"max|v_y|/max|v| <= {SPAN_VY_BOUND!r}": vy_ratio <= SPAN_VY_BOUND,
        "every rebin through K7, none sorted": (
            len(rebins) == span_launches["rebin_move_3d"] and all(rebins)),
        f"{SPAN_STEPS // SPAN_EVERY} frames read back, every particle, finite":
            len(reads) == SPAN_STEPS // SPAN_EVERY and all(
                r[1] == r[2] == n0 and r[7]
                and {"c_rhoatom", "c_patom", "vy"} <= set(r[3]) for r in reads),
        "checkpoints at each frame": all(
            (span_dir / f"restart_{k}.npz").exists()
            for k in range(SPAN_EVERY, SPAN_STEPS + 1, SPAN_EVERY)),
    })
    detail = (f"max|v| {vmax!r}, fluid max|v| {float(speed_sp[fluid].max())!r}, "
              f"max|v_y|/max|v| {vy_ratio!r}, fluid max|rho-1| {rho_dev!r}, fluid "
              f"mean rho {rho_mean!r}, rebins {len(rebins)} (all through K7: "
              f"{all(rebins)}), frames (name, points read, written, fields, "
              f"checkpoint s, frame s, read s, finite) {reads}")
    require(checks, "spanwise main path", detail)
    # where the largest |v_y| sit (x, y, z, |v|), and K3 and K7 against
    # their plain versions on this state at the main path's size
    vy = torch.where(valid, state.v[1].abs(), 0.0).reshape(-1)
    top = torch.topk(vy, 5).indices
    where_vy = [(float(vy[k]), [round(float(state.x[a].reshape(-1)[k]), 4)
                                for a in range(3)],
                 float(speed_sp.reshape(-1)[k])) for k in top.tolist()]
    k3n_err, k3n_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, state, params, geom, spec.pair,
        k1_names, f"K3 periodic spanwise N={Nsp}")
    k3p_abs = max(k3p_abs, k3n_abs)
    what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                             state, geom, _rebin_drop(spec),
                             f"K7 periodic spanwise N={Nsp}")
    k7p_abs = max(k7p_abs, err)
    detail += (f"; max|v_y|/max|v| and fluid max|rho-1| every {SPAN_TRACE} "
               f"steps {vy_trace}; the largest |v_y| (value, x, |v|) "
               f"{where_vy}; on the step-{SPAN_STEPS} state K3 == plain "
               f"(max|diff|/max|ref| per field: "
               + ", ".join(f"{k} {v:.3g}" for k, v in k3n_err.items())
               + f") and K7 == plain walk == sort rebin, bitwise ({what})")
    print(f"[main spanwise] spanwise-periodic cavity N={Nsp} build_spanwise+"
          f"setup+simulate({SPAN_STEPS}, callback every {SPAN_TRACE} steps, "
          f"every {SPAN_EVERY} a Restart + VTK frame with the rho and p "
          f"computes) in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, {geom.ncells} cells, cap "
          f"{geom.cap}, {detail}, launches {span_launches} [{card}]")

    # the resumed run: the step-SPAN_EVERY checkpoint loaded on the card and
    # run to SPAN_STEPS equals the uninterrupted run bit for bit
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    resumed = checkpoint.load(str(span_dir / f"restart_{SPAN_EVERY}.npz"), geom,
                              device=dev)
    load_s = time.perf_counter() - t0
    if int(resumed.step) != SPAN_EVERY or resumed.x.device.type != dev.type:
        raise AssertionError(f"resume: loaded step {int(resumed.step)} on "
                             f"{resumed.x.device}")
    resumed = simulate(resumed, params, spec, SPAN_STEPS - SPAN_EVERY)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    differ = [f.name for f in dataclasses.fields(state)
              if not torch.equal(getattr(state, f.name), getattr(resumed, f.name))]
    if differ:
        raise AssertionError(f"the resumed spanwise run differs from the "
                             f"uninterrupted one in {differ}")
    print(f"[main spanwise resume] checkpoint.load(restart_{SPAN_EVERY}.npz, "
          f"device=cuda) in {load_s!r} s, then simulate({SPAN_STEPS - SPAN_EVERY})"
          f" in {resume_s - load_s!r} s: every field equal to the uninterrupted "
          f"step-{SPAN_STEPS} state bitwise (x, v, rho, tag, valid, step, key "
          f"...), launches "
          f"{ {k: c.launches for k, c in counters.items() if c.launches} }")
    del state, resumed
    shutil.rmtree(span_dir, ignore_errors=True)

    # the spanwise cavity against the JAX package's own runs: at N=20 the
    # fluid's max|v|, kinetic energy and mean density in 2% bands, and at
    # N=12, 20 and 40 max|v_y| / max|v| within 10x JAX's at the same step
    got_vy = {}
    for N, (steps, ref) in SPAN_JAX_VY.items():
        state, params, spec, _ = lid_cavity3d.build_spanwise(N, device=dev)
        state = simulate(setup(state, params, spec, dt=1e-4), params, spec,
                         steps)
        e = _cavity_energy(torch, state, params)
        got_vy[N] = (steps, float(state.v[1][state.valid].abs().max()) / e["max|v|"], ref)
        if N != SPAN_JAX_N:
            continue
        fluid = state.valid & (state.solid_tag == 0)
        got = {"fluid max|v|": e["fluid max|v|"], "fluid ke": e["fluid ke"],
               "fluid mean rho": float(state.rho[fluid].double().mean())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in SPAN_JAX_STEP200.items()}
    checks.update({f"N={N} step {steps}: max|v_y|/max|v| <= 10 x JAX's {ref!r}":
                   ratio <= 10 * ref for N, (steps, ratio, ref) in got_vy.items()})
    detail = (f"N={SPAN_JAX_N}: " + ", ".join(f"{k} {v!r}" for k, v in got.items())
              + "; max|v_y|/max|v| (N, step, card, JAX) "
              + ", ".join(f"({N}, {st}, {r!r}, {ref!r})"
                          for N, (st, r, ref) in got_vy.items()))
    require(checks, "spanwise cavity vs JAX", detail)
    print(f"[main spanwise vs JAX] spanwise cavity on the card vs the JAX "
          f"package's own runs: {detail} (bands {SPAN_JAX_STEP200})")
    del state

    # the 3D FSI beam at the reference's nx (170,632 particles), released
    # half way; every rebin through K7 (its launches are the chunks)
    nf = FSI3D_NX[1]
    state, spec, n0, secs, f3_launches, vmax, checks = run_main(
        lambda: fsi.build_spanwise(nf, tdamp_solid=FSI_RELEASE["main"],
                                   device=dev), 1e-8,
        ("pass_a_3d", "rebin_move_3d"), MAIN_STEPS["fsi3d"])
    built = run_main.built[0]
    start = S.gather_particles(built, spec.geom, ("x", "solid_tag", "fixed_tag"))
    end = S.gather_particles(state, spec.geom, ("x", "v", "rho", "S"))
    beam = (start["solid_tag"] == 1) & (start["fixed_tag"] == 0)
    fluid = start["solid_tag"] == 0
    disp = np.sqrt(((end["x"] - start["x"]) ** 2).sum(1))
    tip = np.argmax(np.where(beam, start["x"][:, 1], -np.inf))
    got = {"max|v|": vmax,
           "fluid max|rho/1000-1|": float(np.abs(end["rho"][fluid] / 1000.0 - 1.0).max()),
           "fluid mean rho": float(end["rho"][fluid].astype(np.float64).mean()),
           "beam max|v|": float(np.sqrt((end["v"][beam] ** 2).sum(1)).max()),
           "beam max|S|": float(np.abs(end["S"][beam]).max()),
           "beam max displacement": float(disp[beam].max()),
           "tip displacement": float(disp[tip])}
    checks.update({
        f"{FSI3D_PARTICLES[nf]} particles": n0 == FSI3D_PARTICLES[nf],
        "tags kept": bool((start["tag"] == end["tag"]).all()),
        "the beam moves and strains (released at step 500)":
            got["beam max|v|"] > 0 and got["beam max|S|"] > 0,
        "max|v| <= 1 (30 x the inlet's 0.0333)": vmax <= 1.0,
    })
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, "3D FSI main path", detail)
    # K3 against the plain loop on the step-1000 state (the beam released,
    # S live), the plain loop over pieces of target cells
    params = run_main.built[1]
    piece = PLAIN_PAIR_BLOCK // spec.geom.cap ** 2
    k3m_main_err, k3m_main_abs, ref = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d, state, params, spec.geom, spec.pair,
        k2_names, f"K3 mechanics nx={nf}", piece=piece)
    live = {k: float(ref[k].abs().max()) for k in ("dS", "ddx", "phi", "nw")}
    if not all(v > 0 for v in live.values()):
        raise AssertionError(f"K3 mechanics nx={nf} parity is vacuous: {live}")
    detail += (f"; on the step-{MAIN_STEPS['fsi3d']} state K3 == plain (its "
               f"loop over {piece} cells at a time; max|.| {live}; "
               f"max|diff|/max|ref| per field: "
               + ", ".join(f"{k} {v:.3g}" for k, v in k3m_main_err.items())
               + f"; max|diff| {k3m_main_abs!r})")
    del ref
    print(f"[main fsi3d] spanwise 3D FSI beam nx={nf} build_spanwise+setup+"
          f"simulate({MAIN_STEPS['fsi3d']}), beam released at "
          f"{FSI_RELEASE['main']}, in {secs[1]!r} s (build {secs[0]!r} s): "
          f"{n0} particles, {spec.geom.ncells} cells, cap {spec.geom.cap}, "
          f"periodic {spec.geom.periodic}, overflow 0, {detail}, launches "
          f"{f3_launches} [{card}]")
    del state, built, start, end

    # the Taylor-Green vortex at 1,000,000 particles
    nt = TGV_N[1]
    dt_t = taylor_green3d.timestep(nt)
    tg_trace = []

    def tg_callback(params, spec):
        def callback(state):
            """max|v| and max|vest| over the valid particles."""
            v, e = state.v[:, state.valid], state.vest[:, state.valid]
            tg_trace.append((int(state.step),
                             float(torch.sqrt((v * v).sum(0)).max()),
                             float(torch.sqrt((e * e).sum(0)).max())))
        return callback

    state, spec, n0, secs, tg_launches, vmax, checks = run_main(
        lambda: taylor_green3d.build(nt, device=dev), dt_t,
        ("pass_a_3d", "rebin_move_3d"), MAIN_STEPS["tgv"], tg_callback,
        callback_every=TGV_TRACE)
    params = run_main.built[1]
    e0 = taylor_green3d.kinetic_energy(run_main.built[0], params)
    t_end = MAIN_STEPS["tgv"] * dt_t
    # the early viscous decay with nu = U0 / Re = 0.01: each mode has |k|^2
    # = 3; the JAX package's N=20 run to the same t dissipates more
    decay = math.exp(-6 * 0.01 * t_end)
    ratio = taylor_green3d.kinetic_energy(state, params) / e0
    rho_mean = float(state.rho[state.valid].double().mean())
    lo = 0.98 * TGV_JAX_STEP200["E/E0"][0]
    # the density varies by O(Mach^2) = 1e-2 at c0 = 10 U0; its mean is
    # not conserved by the continuity equation and the Shepard filter
    checks.update({
        f"{TGV_PARTICLES[nt]} particles": n0 == TGV_PARTICLES[nt],
        f"E/E0 in [{lo!r}, 1.01 x exp(-6 nu t)]": lo <= ratio <= 1.01 * decay,
        "|mean rho - 1| <= 1e-2": abs(rho_mean - 1.0) <= 1e-2,
    })
    detail = (f"t {t_end!r}, E/E0 {ratio!r} vs exp(-6 nu t) {decay!r} (the "
              f"JAX package's N={TGV_JAX_N}: {TGV_JAX_STEP200['E/E0'][0]!r}), "
              f"max|v| {vmax!r}, mean rho {rho_mean!r}, max|rho-1| "
              f"{float((state.rho[state.valid] - 1.0).abs().max())!r}; (step, "
              f"max|v|, max|vest|) every {TGV_TRACE} steps {tg_trace}")
    require(checks, "Taylor-Green main path", detail)
    # K3 and K7 against their plain versions on the step-1000 state: K3's
    # with x jittered by up to 0.1 spacing, as in [K3 solid-free] (the flow
    # carries whole lattice patches, on which ddv cancels to a small part of
    # its terms: K3 and the plain loop in f32 differ there by 1.7e-5 of
    # max|ddv|), and as run, K3 and the plain f32 loop each against the
    # plain loop in f64
    k3n_err, k3n_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_3d,
        _jitter(torch, state, taylor_green3d.L / nt, seed=11), params,
        spec.geom, spec.pair, k2_names, f"K3 solid-free N={nt}")
    k3sf_abs = max(k3sf_abs, k3n_abs)
    k3n_f64 = _f64_parity(torch, pair, pair_cuda.pass_a_3d, state, params,
                          spec.geom, spec.pair, k2_names,
                          f"K3 solid-free N={nt} vs f64",
                          PLAIN_PAIR_BLOCK // spec.geom.cap ** 2)
    what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                             state, spec.geom, _rebin_drop(spec),
                             f"K7 large cap vortex N={nt}")
    k7l_abs = max(k7l_abs, err)
    detail += (f"; on the step-{MAIN_STEPS['tgv']} state jittered K3 == plain "
               f"(max|diff|/max|ref| per field: "
               + ", ".join(f"{k} {v:.3g}" for k, v in k3n_err.items())
               + f"), unjittered against the plain loop in f64 (max|diff|/"
               f"max|f64| per field, K3 / the plain f32 loop: "
               + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in
                           k3n_f64.items() if a or b)
               + f") and K7 == plain walk == sort rebin, bitwise ({what})")
    print(f"[main tgv3d] Taylor-Green vortex N={nt} build+setup+simulate("
          f"{MAIN_STEPS['tgv']}) at dt {dt_t!r} in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, {spec.geom.ncells} cells, cap "
          f"{spec.geom.cap}, no solids, overflow 0, {detail}, launches "
          f"{tg_launches} [{card}]")
    del state

    # both 3D paths at small sizes against the JAX package's own runs
    state, params, spec, _ = fsi.build_spanwise(
        FSI3D_JAX_NX, tdamp_solid=FSI3D_JAX_RELEASE, rebin_every=FSI3D_JAX_REBIN,
        device=dev)
    state = simulate(setup(state, params, spec, dt=1e-8), params, spec,
                     FSI3D_JAX_STEPS)
    valid = state.valid
    solid = state.solid_tag == 1
    fluid = valid & ~solid
    beam = valid & solid & (state.fixed_tag == 0)
    speed_f = torch.sqrt((state.v * state.v).sum(0))
    got = {"max|v|": float(speed_f[valid].max()),
           "fluid max|rho/1000-1|": float((state.rho[fluid] / 1000.0 - 1.0)
                                          .abs().max()),
           "fluid mean rho": float(state.rho[fluid].double().mean()),
           "beam max|v|": float(speed_f[beam].max()),
           "beam max|S|": float(state.S.abs().amax(dim=(0, 1))[beam].max())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in FSI3D_JAX_STEP20.items()}
    checks["overflow 0"] = int(state.overflow) == 0
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, f"3D FSI nx={FSI3D_JAX_NX} vs JAX", detail)
    print(f"[main fsi3d vs JAX] spanwise 3D FSI beam nx={FSI3D_JAX_NX}, "
          f"{FSI3D_JAX_STEPS} steps (released at {FSI3D_JAX_RELEASE}, rebin "
          f"every {FSI3D_JAX_REBIN}) on the card vs the JAX package's own run: "
          f"{detail} (bands {FSI3D_JAX_STEP20})")
    nt = TGV_JAX_N
    state, params, spec, _ = taylor_green3d.build(nt, device=dev)
    e0 = taylor_green3d.kinetic_energy(state, params)
    state = simulate(setup(state, params, spec, dt=taylor_green3d.timestep(nt)),
                     params, spec, TGV_JAX_STEPS)
    speed_t = torch.sqrt((state.v * state.v).sum(0))
    got = {"E/E0": taylor_green3d.kinetic_energy(state, params) / e0,
           "max|v|": float(speed_t[state.valid].max()),
           "mean rho": float(state.rho[state.valid].double().mean())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in TGV_JAX_STEP200.items()}
    checks["overflow 0"] = int(state.overflow) == 0
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, f"Taylor-Green N={nt} vs JAX", detail)
    print(f"[main tgv3d vs JAX] Taylor-Green vortex N={nt}, {TGV_JAX_STEPS} "
          f"steps on the card vs the JAX package's own run: {detail} (bands "
          f"{TGV_JAX_STEP200})")
    del state

    # in-run load balancing: the s=20 drifting blob, balanced at build and
    # re-cut in the run, then the same blob on the uniform grid
    sb, steps = BLOB_S[1], MAIN_STEPS["blob"]
    blob_dt = drift_blob.timestep(sb)
    blob_kernels = ("pass_a_2d_rowloop", "rebin_move_2d_gated")
    log = []
    state, spec, n0, secs, blob_launches, vmax, checks = run_main(
        lambda: drift_blob.build(sb, balance=True, inrun=True, device=dev),
        blob_dt, blob_kernels, steps, balance_log=log)
    cap, fix = spec.geom.cap, spec.balance
    cuts = [c for c in log if c["geom"] is not None]
    rep = report(state, _current_geom(spec.geom, log), fix.n_shards)

    def improved(c):
        """The re-cut fired a trigger and improved the metric that fired."""
        by_imb = c["imbalance"] > fix.threshold and c["new_imbalance"] < c["imbalance"]
        by_occ = (c["max_occ"] >= fix.occ_frac * cap
                  and c["new_max_occ"] < c["max_occ"])
        return (by_imb or by_occ) and c["new_imbalance"] < 1.5 \
            and c["new_max_occ"] <= cap

    checks.update({
        f"{BLOB_N[sb]} particles": n0 == BLOB_N[sb],
        "x_edges from the build": spec.geom.x_edges is not None,
        ">= 2 accepted re-cuts": len(cuts) >= 2,
        "distinct edge sets": len({c["geom"].x_edges for c in cuts}) == len(cuts),
        "each re-cut improved its firing metric": all(map(improved, cuts)),
        "final slab imbalance < 1.5": rep["imbalance"] < 1.5,
        "max|v| within 1e-3 of the drift speed 2.0": abs(vmax - 2.0) <= 1e-3,
    })
    detail = (f"max|v| {vmax!r}, re-cuts "
              + "; ".join(f"step {c['step']}: imbalance {c['imbalance']} -> "
                          f"{c['new_imbalance']}, max_occ {c['max_occ']} -> "
                          f"{c['new_max_occ']}" for c in cuts)
              + f", refusals {[(c['step'], c['reason']) for c in log if c['geom'] is None]}"
              f", final slab counts {rep['counts']} (imbalance {rep['imbalance']})")
    require(checks, "load-balance main path", detail)
    print(f"[main balance] drifting blob s={sb} Scene.balance+fix_balance -> "
          f"build+setup+simulate({steps}, balance_log) in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, grid {spec.geom.ncells[:2]} cap "
          f"{cap} -> {_current_geom(spec.geom, log).ncells[:2]}, {detail}, "
          f"launches {blob_launches}")
    balanced = S.gather_particles(state, spec.geom, ("x", "v", "rho"))
    del state

    state, spec_u, n0u, secs_u, uni_launches, vmax_u, checks = run_main(
        lambda: drift_blob.build(sb, device=dev), blob_dt, blob_kernels, steps)
    checks[f"{BLOB_N[sb]} particles"] = n0u == BLOB_N[sb]
    require(checks, "uniform blob run", f"max|v| {vmax_u!r}")
    uniform = S.gather_particles(state, spec_u.geom, ("x", "v", "rho"))
    del state
    diff = {k: balanced[k] - uniform[k] for k in BLOB_TOL}
    span = spec_u.geom.hi[0] - spec_u.geom.lo[0]
    diff["x"][:, 0] -= span * np.round(diff["x"][:, 0] / span)
    err = {k: float(np.abs(d).max()) for k, d in diff.items()}
    if not ((balanced["tag"] == uniform["tag"]).all()
            and all(err[k] <= BLOB_TOL[k] for k in BLOB_TOL)):
        raise AssertionError(f"balanced blob != uniform blob: {err} "
                             f"(bounds {BLOB_TOL})")
    print(f"[main balance] uniform blob s={sb} (grid {spec_u.geom.ncells[:2]}, "
          f"cap {spec_u.geom.cap}) build+setup+simulate({steps}) in "
          f"{secs_u[1]!r} s, launches {uni_launches}; balanced vs uniform "
          f"tag by tag: max|diff| {err} (bounds {BLOB_TOL}; tags equal) [{card}]")
    del balanced, uniform, diff

    # the doubly periodic 2D Taylor-Green vortex at 1,000,000 particles: K2
    # (solid-free, periodic x and y) and K5 on both periodic axes
    nv = TGV2D_N
    dt_v = taylor_green2d.timestep(nv)
    state, spec, n0, secs, tgv2d_launches, vmax, checks = run_main(
        lambda: taylor_green2d.build(nv, device=dev), dt_v,
        ("pass_a_2d_rowloop", "rebin_move_2d"), MAIN_STEPS["tgv2d"])
    params = run_main.built[1]
    e0 = taylor_green2d.kinetic_energy(run_main.built[0], params)
    t_end = MAIN_STEPS["tgv2d"] * dt_v
    # the viscous decay with nu = U0 / Re = 0.01 (the mode has |k|^2 = 2);
    # the JAX package's N=60 run dissipates more, over a longer t
    decay = math.exp(-4 * 0.01 * t_end)
    ratio = taylor_green2d.kinetic_energy(state, params) / e0
    rho_mean = float(state.rho[state.valid].double().mean())
    lo = 0.98 * TGV2D_JAX["E/E0"][0]
    checks.update({
        f"{TGV2D_PARTICLES} particles": n0 == TGV2D_PARTICLES,
        f"E/E0 in [{lo!r}, 1.01 x exp(-4 nu t)]": lo <= ratio <= 1.01 * decay,
        "|mean rho - 1| <= 1e-2": abs(rho_mean - 1.0) <= 1e-2,
    })
    detail = (f"t {t_end!r}, E/E0 {ratio!r} vs exp(-4 nu t) {decay!r} (the "
              f"JAX package's N={TGV2D_JAX_N} at step {TGV2D_JAX_STEPS}: "
              f"{TGV2D_JAX['E/E0'][0]!r}), max|v| {vmax!r}, mean rho "
              f"{rho_mean!r}, max|rho-1| "
              f"{float((state.rho[state.valid] - 1.0).abs().max())!r}")
    require(checks, "2D Taylor-Green main path", detail)
    # K2's solid-free and periodic-y branches meet on this run: on the
    # step-1000 state, as [main tgv3d] holds K3, K2 against the plain loop
    # with x jittered by up to 0.1 spacing (the vortex carries whole lattice
    # patches, on which ddv cancels to a small part of its terms: K2 and the
    # plain f32 loop differ there by 2.1e-5 of max|ddv| as run), and as run
    # K2 and the plain f32 loop each against the plain loop in f64; then K5
    # against the plain walk and the sort
    k2v_err, k2v_abs, _ = _pass_a_parity(
        torch, pair, pair_cuda.pass_a_2d_rowloop,
        _jitter(torch, state, taylor_green2d.L / nv, seed=11), params,
        spec.geom, spec.pair, k2_names, f"K2 solid-free periodic N={nv}")
    k2sf_abs = max(k2sf_abs, k2v_abs)  # K2 solid-free's entry: both paths
    k2v_f64 = _f64_parity(torch, pair, pair_cuda.pass_a_2d_rowloop, state,
                          params, spec.geom, spec.pair, k2_names,
                          f"K2 solid-free periodic N={nv} vs f64", None)
    what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_2d,
                             state, spec.geom, _rebin_drop(spec),
                             f"K5 periodic vortex N={nv}")
    k5p_abs = max(k5p_abs, err)
    print(f"[main tgv2d] 2D Taylor-Green vortex N={nv} build+setup+simulate("
          f"{MAIN_STEPS['tgv2d']}) at dt {dt_v!r} in {secs[1]!r} s (build "
          f"{secs[0]!r} s): {n0} particles, {spec.geom.ncells[:2]} cells, cap "
          f"{spec.geom.cap}, periodic x and y, no solids, overflow 0, "
          f"{detail}; on the step-{MAIN_STEPS['tgv2d']} state jittered K2 "
          f"== plain (max|diff|/max|ref| per field: "
          + ", ".join(f"{k} {v:.3g}" for k, v in k2v_err.items())
          + f"), unjittered against the plain loop in f64 (max|diff|/"
          f"max|f64| per field, K2 / the plain f32 loop: "
          + ", ".join(f"{k} {a:.3g} / {b:.3g}" for k, (a, b) in
                      k2v_f64.items() if a or b)
          + f") and K5 == plain walk == sort rebin, bitwise ({what}); "
          f"launches {tgv2d_launches} [{card}]")
    del state
    nj = TGV2D_JAX_N
    state, params, spec, _ = taylor_green2d.build(nj, device=dev)
    e0 = taylor_green2d.kinetic_energy(state, params)
    state = simulate(setup(state, params, spec,
                           dt=taylor_green2d.timestep(nj)), params, spec,
                     TGV2D_JAX_STEPS)
    speed_v = torch.sqrt((state.v * state.v).sum(0))
    got = {"E/E0": taylor_green2d.kinetic_energy(state, params) / e0,
           "max|v|": float(speed_v[state.valid].max()),
           "mean rho": float(state.rho[state.valid].double().mean())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in TGV2D_JAX.items()}
    checks["overflow 0"] = int(state.overflow) == 0
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, f"2D Taylor-Green N={nj} vs JAX", detail)
    print(f"[main tgv2d vs JAX] 2D Taylor-Green vortex N={nj}, "
          f"{TGV2D_JAX_STEPS} steps on the card vs the JAX package's own run: "
          f"{detail} (bands {TGV2D_JAX})")
    del state

    # the 3D drifting blob at s=8: x_edges on a grid periodic in x and z,
    # re-cut in the run (K3 solid-free at every step, K7 with x_edges at
    # every in-place rebin; a re-cut is a sort rebin into the new geometry,
    # not a K7 launch), then the same blob on the uniform grid
    sb3, steps = BLOB3D_S, MAIN_STEPS["blob3d"]
    dt_b3 = drift_blob.timestep(sb3)
    log3 = []
    state, spec, n0, secs, blob3d_launches, vmax, checks = run_main(
        lambda: drift_blob.build(sb3, True, True, device=dev,
                                 nz_cells=BLOB3D_NZ),
        dt_b3, ("pass_a_3d", "rebin_move_3d"), steps, balance_log=log3)
    cap3, fix3 = spec.geom.cap, spec.balance
    cuts3 = [c for c in log3 if c["geom"] is not None]
    geom3 = _current_geom(spec.geom, log3)
    rep3 = report(state, geom3, fix3.n_shards)

    def improved3(c):
        """The re-cut fired a trigger and improved the metric that fired."""
        by_imb = (c["imbalance"] > fix3.threshold
                  and c["new_imbalance"] < c["imbalance"])
        by_occ = (c["max_occ"] >= fix3.occ_frac * cap3
                  and c["new_max_occ"] < c["max_occ"])
        return (by_imb or by_occ) and c["new_max_occ"] <= cap3

    checks.update({
        f"{BLOB3D_PARTICLES} particles": n0 == BLOB3D_PARTICLES,
        "x_edges on a grid periodic in x and z": (
            spec.geom.x_edges is not None
            and spec.geom.periodic == (True, False, True)),
        ">= 1 accepted re-cut": len(cuts3) >= 1,
        "each re-cut improved its firing metric": all(map(improved3, cuts3)),
        "max|v| within 1e-3 of the drift speed 2.0": abs(vmax - 2.0) <= 1e-3,
    })
    detail = (f"max|v| {vmax!r}, re-cuts (sort rebins) "
              + "; ".join(f"step {c['step']}: imbalance {c['imbalance']} -> "
                          f"{c['new_imbalance']}, max_occ {c['max_occ']} -> "
                          f"{c['new_max_occ']}" for c in cuts3)
              + f", refusals {[(c['step'], c['reason']) for c in log3 if c['geom'] is None and 'reason' in c]}"
              f", final slab counts {rep3['counts']} (imbalance "
              f"{rep3['imbalance']})")
    require(checks, "3D blob main path", detail)
    what, err = _move_parity(torch, S, rebin_cuda, rebin_cuda.rebin_move_3d,
                             state, geom3, _rebin_drop(spec),
                             f"K7 edges periodic blob s={sb3} step {steps}")
    k7ep_abs = max(k7ep_abs, err)
    print(f"[main blob3d] 3D drifting blob s={sb3} Scene.balance+fix_balance "
          f"-> build+setup+simulate({steps}, balance_log) in {secs[1]!r} s "
          f"(build {secs[0]!r} s): {n0} particles, grid {spec.geom.ncells} cap "
          f"{cap3} -> {geom3.ncells}, {detail}; every in-place rebin through "
          f"K7 with x_edges on the periodic grid ({blob3d_launches['rebin_move_3d']}"
          f" launches: setup and {steps // spec.rebin_every} chunks), "
          f"{len(cuts3)} re-cuts sorted; on the step-{steps} state K7 == "
          f"plain walk == sort rebin, bitwise ({what}); launches "
          f"{blob3d_launches} [{card}]")
    balanced = S.gather_particles(state, spec.geom, ("x", "v", "rho"))
    del state
    state, spec_u, n0u, secs_u, uni3_launches, vmax_u, checks = run_main(
        lambda: drift_blob.build(sb3, device=dev, nz_cells=BLOB3D_NZ), dt_b3,
        ("pass_a_3d", "rebin_move_3d"), steps)
    checks[f"{BLOB3D_PARTICLES} particles"] = n0u == BLOB3D_PARTICLES
    require(checks, "uniform 3D blob run", f"max|v| {vmax_u!r}")
    uniform = S.gather_particles(state, spec_u.geom, ("x", "v", "rho"))
    del state
    diff = {k: balanced[k] - uniform[k] for k in BLOB3D_TOL}
    span = spec_u.geom.hi[0] - spec_u.geom.lo[0]
    diff["x"][:, 0] -= span * np.round(diff["x"][:, 0] / span)
    span_z = spec_u.geom.hi[2] - spec_u.geom.lo[2]
    diff["x"][:, 2] -= span_z * np.round(diff["x"][:, 2] / span_z)
    err3 = {k: float(np.abs(d).max()) for k, d in diff.items()}
    if not ((balanced["tag"] == uniform["tag"]).all()
            and all(err3[k] <= BLOB3D_TOL[k] for k in BLOB3D_TOL)):
        raise AssertionError(f"balanced 3D blob != uniform 3D blob: {err3} "
                             f"(bounds {BLOB3D_TOL})")
    print(f"[main blob3d] uniform 3D blob s={sb3} (grid {spec_u.geom.ncells}, "
          f"cap {spec_u.geom.cap}) build+setup+simulate({steps}) in "
          f"{secs_u[1]!r} s, launches {uni3_launches}; balanced vs uniform "
          f"tag by tag: max|diff| {err3} (bounds {BLOB3D_TOL}; tags equal) "
          f"[{card}]")
    del balanced, uniform, diff
    sj = BLOB3D_JAX_S
    state, params, spec, _ = drift_blob.build(sj, True, True, device=dev,
                                              nz_cells=BLOB3D_NZ)
    state = simulate(setup(state, params, spec, dt=drift_blob.timestep(sj)),
                     params, spec, BLOB3D_JAX_STEPS)
    valid = state.valid
    got = {"max|v|": float(torch.sqrt((state.v * state.v).sum(0))[valid].max()),
           "mean rho": float(state.rho[valid].double().mean()),
           "mean x": float(state.x[0][valid].double().mean())}
    checks = {f"{name} in [{lo}, {hi}] x JAX's {ref}": lo * ref <= got[name] <= hi * ref
              for name, (ref, lo, hi) in BLOB3D_JAX.items()}
    checks["overflow 0"] = int(state.overflow) == 0
    detail = ", ".join(f"{k} {v!r}" for k, v in got.items())
    require(checks, f"3D blob s={sj} vs JAX", detail)
    print(f"[main blob3d vs JAX] 3D drifting blob s={sj} (balanced, "
          f"fix_balance), {BLOB3D_JAX_STEPS} steps on the card vs the JAX "
          f"package's own run: {detail} (bands {BLOB3D_JAX})")
    del state

    # small-input references: the card's kernel paths vs the CPU plain paths
    # bounds relative to each field's max|value| on the CPU: x 1e-5, v 1e-3,
    # rho 1e-4, S 1e-3 (the cavity's lid speed and density are 1)
    # the convection's C: 1e-4 (its Dirichlet value on the cylinder is 1)
    bounds = {"x": 1e-5, "v": 1e-3, "rho": 1e-4, "S": 1e-3, "C": 1e-4}

    def card_vs_cpu(label, path, build, dt, fields):
        runs, logs = {}, {}
        steps = SMALL_STEPS[path]
        for where in ("cpu", dev):
            s, p, sp, _ = build(where)
            log = logs[str(where)] = []
            s = simulate(setup(s, p, sp, dt=dt), p, sp, steps, balance_log=log)
            runs[str(where)] = S.gather_particles(s, sp.geom, fields)
        a, b = runs["cpu"], runs[str(dev)]
        rel = {k: float(abs(a[k] - b[k]).max()) / max(float(abs(a[k]).max()), 1e-30)
               for k in fields}
        recuts = {w: [(c["step"], c["geom"] and c["geom"].x_edges) for c in lg]
                  for w, lg in logs.items()}
        if not ((a["tag"] == b["tag"]).all()
                and all(rel[k] <= bounds[k] for k in fields)
                and recuts["cpu"] == recuts[str(dev)]):
            raise AssertionError(f"{label} card run != CPU plain run: {rel}, "
                                 f"re-cut steps {recuts}")
        print(f"[main] {label}, {steps} steps: card kernels vs CPU plain path, "
              f"max|diff|/max|cpu| {rel} (bounds {bounds}; tags equal; re-cuts "
              f"at steps {[c[0] for c in recuts['cpu'] if c[1]]} on both, "
              f"same edges)")
        return s  # the card's state

    card_vs_cpu(f"cavity N={SMALL['cavity']}", "cavity",
                lambda d: lid_cavity.build(N=SMALL["cavity"], device=d), 1e-4,
                ("x", "v", "rho"))
    card_vs_cpu(f"fsi nx={SMALL['fsi']} (beam released at step 5)", "fsi",
                lambda d: fsi.build(nx=SMALL["fsi"], rebin_every=10,
                                    tdamp_solid=5, device=d),
                1e-8, ("x", "v", "rho", "S"))
    card_vs_cpu(f"lid_cavity3d N={SMALL['cavity3d']}", "cavity3d",
                lambda d: lid_cavity3d.build(N=SMALL["cavity3d"], device=d), 1e-4,
                ("x", "v", "rho"))
    card_vs_cpu(f"balanced drifting blob s={SMALL['blob']} with fix_balance",
                "blob", lambda d: drift_blob.build(SMALL["blob"], balance=True,
                                                   inrun=True, device=d),
                drift_blob.timestep(SMALL["blob"]), ("x", "v", "rho"))

    card_vs_cpu(f"natural convection N={SMALL['convection']}", "convection",
                lambda d: natural_convection.build(N=SMALL["convection"],
                                                   device=d),
                1e-4, ("x", "v", "rho", "C"))
    card_vs_cpu(f"cell polarization nx={SMALL['polarization']}", "polarization",
                lambda d: cell_polarization.build(nx=SMALL["polarization"],
                                                  rebin_every=5, device=d),
                1e-10, ("x", "v", "rho", "C", "S"))
    card_vs_cpu(f"spanwise-periodic cavity N={SMALL['spanwise']}", "spanwise",
                lambda d: lid_cavity3d.build_spanwise(SMALL["spanwise"], device=d),
                1e-4, ("x", "v", "rho"))
    card_vs_cpu(f"visible-noise cavity N={SMALL['thermal']} (e 1, kB "
                f"{VISIBLE_KBE!r})", "thermal",
                lambda d: _visible_cavity(SMALL["thermal"], d), 1e-4,
                ("x", "v", "rho"))

    # the stochastic species, the four remaining integrators and the
    # LAMMPS-script front end
    _ssa_paths(torch, dev, card, kind, counters, card_vs_cpu)

    # -- 10. speed ----------------------------------------------------------
    def speed(label, path, size, state, params, spec, pass_a, move,
              plain_piece=None):
        """Steady-state particle-steps/s of ``simulate`` (with its re-cuts
        when ``spec.balance`` is set), then per call, on the geometry the run
        ended on: pass A and the move beside their plain versions (pass A's
        over ``plain_piece`` target cells at a time), the rebin with the
        kernel beside the sort
        rebin, the bounds, and with ``spec.balance`` the re-cut: the host
        time of a ``rebalance`` forced to cut and the sort rebin into its
        geometry; pass A's launches per timed run."""
        steps, iters = SPEED_STEPS[path][size]
        n = int(state.n_valid)
        every = spec.balance.every if spec.balance is not None else None
        # a warm-up chunk on a copy (shorter than a balance period: no
        # re-cut), then the timed runs, each from a copy of the set-up state
        simulate(_clone(torch, state), params, spec, spec.rebin_every)
        launched = pass_a.launches
        runs = [_timed_chunks(torch, simulate, _clone(torch, state), params,
                              spec, steps)
                for _ in range(SPEED_REPEATS[path])]
        launched = (pass_a.launches - launched) // len(runs)
        state, log = runs[-1][:2]
        geom = _current_geom(spec.geom, log)
        cfg = dataclasses.replace(spec.pair, density_filter_accs=False)
        drop = _rebin_drop(spec)
        t = _move_timing(torch, S, rebin_cuda, move, state, geom, drop, iters)
        # the plain pass A takes 0.2-13 s a call on a 3D grid: one timed
        # call there (after the two warm-up calls) keeps the phase well
        # inside the script's time limit
        t.update(pass_a_timing(pass_a, state, params, geom, cfg, iters,
                               plain_piece, 1 if geom.dim == 3 else None))
        t.update({
            "rebin_kernel": _per_call_ms(
                torch, lambda: S.rebin(state, geom, drop=drop, use_kernel=True),
                iters),
            "rebin_sort": _per_call_ms(
                torch, lambda: S.rebin(state, geom, drop=drop, use_kernel=False),
                iters),
            "rebin_host": _host_ms(
                torch, lambda: S.rebin(state, geom, drop=drop, use_kernel=True),
                iters),
        })
        slots = geom.cap * geom.ncells_total
        species = ""
        if params.n_sdpd:
            # the same kernel on the same state without its species rows
            bare_s = dataclasses.replace(state, C=state.C[:0], Q=state.Q[:0])
            bare_p = dataclasses.replace(params, kappa=params.kappa[..., :0])
            pf0 = pair._per_particle(bare_s, bare_p, cfg)
            t["pass_a_no_species"] = _per_call_ms(
                torch, lambda: pass_a(pf0, bare_p, geom, cfg,
                                      pair.noise_inputs(bare_s)), iters)
            species = (f" with its {params.n_sdpd} species row(s), "
                       f"{t['pass_a_no_species']!r} without them,")
        if cfg.thermal:
            # the same kernel on the same state without its thermal rows
            quiet = dataclasses.replace(cfg, thermal=False)
            pfq = pair._per_particle(state, params, quiet)
            t["pass_a_no_thermal"] = _per_call_ms(
                torch, lambda: pass_a(pfq, params, geom, quiet), iters)
            species += (f" with its thermal rows, "
                        f"{t['pass_a_no_thermal']!r} without them,")
        t["launches"] = launched
        t["rates"] = [n * steps / secs for _, _, secs, _ in runs]
        t["rate"] = sum(t["rates"]) / len(t["rates"])
        t["chunks"] = [_chunk_split(ch, lg, every) for _, lg, _, ch in runs]
        t["chunk"] = spec.rebin_every
        recut = ""
        if spec.balance is not None:
            force = dataclasses.replace(spec.balance, threshold=0.0, min_gain=0.0)
            host_s = []
            for _ in range(iters):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                new_geom, info = rebalance(state, geom, force)
                host_s.append(time.perf_counter() - t1)
            if new_geom is None:
                raise AssertionError(f"{label}: a forced re-cut was refused: {info}")
            t["recut_host_ms"] = 1e3 * sum(host_s) / len(host_s)
            t["recut_rebin_ms"] = _per_call_ms(
                torch, lambda: S.rebin(state, new_geom, drop=drop,
                                       use_kernel=False, drift_check=False),
                iters)
            recut = (f"; re-cuts in the timed run at steps "
                     f"{[c['step'] for c in log if c['geom'] is not None]}; a "
                     f"forced re-cut: rebalance {t['recut_host_ms']!r} ms on the "
                     f"host clock (readback, host cut), its sort rebin "
                     f"{t['recut_rebin_ms']!r} ms")
        print(f"[speed] {label}: {n} particles, cap {geom.cap}, "
              f"{geom.ncells_total} cells, {steps} steps (rebin every "
              f"{min(steps, spec.rebin_every)}) from the set-up state, "
              f"{len(runs)} run(s) in {[secs for _, _, secs, _ in runs]!r} s = "
              f"{t['rates']!r} particle-steps/s; per chunk, median (host ms, "
              f"device-timeline ms) and count: {t['chunks']}; per call ms: "
              f"{pass_a.__name__} {t['pass_a']!r}{species} vs plain pass A "
              f"{t['pass_a_plain']!r}; {move.__name__}"
              f"{' (x_edges)' if geom.x_edges else ''} {t['move']!r} vs plain "
              f"walk {t['move_plain']!r}; rebin with the kernel "
              f"{t['rebin_kernel']!r} ({t['rebin_host']!r} on the host clock) "
              f"vs sort rebin {t['rebin_sort']!r}{recut}; "
              f"bounds at occupancy {n / slots!r} ({n} of {slots} slots): pass "
              f"A {t['pass_a_bound']} ({t['pass_a_work']}), move "
              f"{t['move_bound']} ({t['move_rows']} + {t['move_rows']} rows) "
              f"[{card}]")
        return t

    t_cav = {}
    for N, dt in zip(CAVITY_N, (1e-4, 5e-6)):  # lid_cavity's dt rule past 200
        state, params, spec, _ = lid_cavity.build(N=N, dt=dt, device=dev)
        state = setup(state, params, spec, dt=dt)
        t_cav[N] = speed(f"cavity N={N}", "cavity", N, state, params, spec,
                         pair_cuda.pass_a_2d, rebin_cuda.rebin_move_2d)
        if N != GROUPED_N:  # K1 and K4 at GROUPED_N: the [main preshift] state
            k1_k4_timing(
                f"flagship N={N} set-up state", state, params, spec.geom,
                spec.pair, {"K1": cav_launches["pass_a_2d"],
                            "K4": "none (the N=200 main path runs K1)"})
        del state
    t_conv = {}
    for N in CONV_N:
        state, params, spec, _ = natural_convection.build(N=N, dt=CONV_DT[N],
                                                          device=dev)
        state = setup(state, params, spec, dt=CONV_DT[N])
        t_conv[N] = speed(f"natural convection N={N} (dt {CONV_DT[N]})",
                          "convection", N, state, params, spec,
                          pair_cuda.pass_a_2d, rebin_cuda.rebin_move_2d)
        del state
    # the convection with the noise on (the SI kB, e 1e-6): K1's thermal rows
    t_conv_thermal = {}
    for N in CONV_N:
        state, params, spec, _ = _with_noise(natural_convection.build(
            N=N, dt=CONV_DT[N], device=dev))
        state = setup(state, params, spec, dt=CONV_DT[N])
        t_conv_thermal[N] = speed(
            f"natural convection N={N} (dt {CONV_DT[N]}) with thermal=True",
            "convection", N, state, params, spec, pair_cuda.pass_a_2d,
            rebin_cuda.rebin_move_2d)
        del state
    t_fsi = {}
    for nx in FSI_NX:
        state, params, spec, _ = fsi.build(nx=nx, rebin_every=FSI_REBIN[nx],
                                           device=dev)
        state = setup(state, params, spec, dt=1e-8)
        t_fsi[nx] = speed(f"fsi nx={nx}", "fsi", nx, state, params, spec,
                          pair_cuda.pass_a_2d_rowloop,
                          rebin_cuda.rebin_move_2d_gated)
        del state
    t_polar = {}
    for nx in POLAR_NX:
        state, params, spec, _ = cell_polarization.build(nx=nx, dt=POLAR_DT[nx],
                                                         device=dev)
        state = setup(state, params, spec, dt=POLAR_DT[nx])
        h, c0 = params.max_cut, float(params.c0.max())
        nu = float((params.visc / params.rho0[:, None]).max())
        t_polar[nx] = speed(
            f"cell polarization nx={nx} (dt {POLAR_DT[nx]}; limits: acoustic "
            f"0.25 h/c0 {0.25 * h / c0!r}, viscous 0.125 h^2 rho/eta "
            f"{0.125 * h * h / nu!r})", "polarization", nx, state, params, spec,
            pair_cuda.pass_a_2d_rowloop, rebin_cuda.rebin_move_2d_gated)
        del state
    t_c3 = {}
    for N in CAVITY3D_N:
        state, params, spec, _ = lid_cavity3d.build(N=N, device=dev)
        state = setup(state, params, spec, dt=1e-4)
        t_c3[N] = speed(f"lid_cavity3d N={N}", "cavity3d", N, state, params,
                        spec, pair_cuda.pass_a_3d, rebin_cuda.rebin_move_3d)
        del state
    t_span = {}
    for N in SPAN_N:
        state, params, spec, _ = lid_cavity3d.build_spanwise(N, device=dev)
        state = setup(state, params, spec, dt=1e-4)
        t_span[N] = speed(f"spanwise-periodic cavity N={N}", "spanwise", N,
                          state, params, spec, pair_cuda.pass_a_3d,
                          rebin_cuda.rebin_move_3d)
        del state
    # the 3D FSI beam (frozen, as the model keeps it until step 1e6) and the
    # Taylor-Green vortex; at nx=60 (cap 296) the plain pass A runs over
    # pieces of target cells (its whole [cap, cap, NC] blocks take ~10 GB a
    # 3 x 3 tensor)
    t_fsi3d = {}
    for nx in FSI3D_NX:
        state, params, spec, _ = fsi.build_spanwise(nx, device=dev)
        state = setup(state, params, spec, dt=1e-8)
        t_fsi3d[nx] = speed(
            f"3D FSI beam nx={nx}", "fsi3d", nx, state, params, spec,
            pair_cuda.pass_a_3d, rebin_cuda.rebin_move_3d,
            None if nx == FSI3D_NX[0] else PLAIN_PAIR_BLOCK // spec.geom.cap ** 2)
        del state
    t_tgv = {}
    for N in TGV_N:
        state, params, spec, _ = taylor_green3d.build(N, device=dev)
        state = setup(state, params, spec, dt=taylor_green3d.timestep(N))
        t_tgv[N] = speed(f"Taylor-Green vortex N={N}", "tgv", N, state, params,
                         spec, pair_cuda.pass_a_3d, rebin_cuda.rebin_move_3d)
        del state
    t_blob = {}
    for sb in BLOB_S:
        for bal in (True, False):
            state, params, spec, _ = drift_blob.build(sb, balance=bal,
                                                      inrun=bal, device=dev)
            state = setup(state, params, spec, dt=drift_blob.timestep(sb))
            t_blob[sb, bal] = speed(
                f"drifting blob s={sb} "
                + ("balanced, with fix_balance" if bal else "uniform"), "blob",
                sb, state, params, spec, pair_cuda.pass_a_2d_rowloop,
                rebin_cuda.rebin_move_2d_gated)
            del state
    for sb in BLOB_S:
        b, u = t_blob[sb, True], t_blob[sb, False]

        def per_chunk(t, kind, i):
            """Mean over the runs of the median ``kind`` chunk's host (i=0)
            or device-timeline (i=1) ms."""
            v = [c[kind][0][i] for c in t["chunks"] if kind in c]
            return sum(v) / len(v) if v else float("nan")

        chunk = b["chunk"]
        print(f"[speed] drifting blob s={sb}: balanced / uniform particle-steps/s "
              f"per run {[x / y for x, y in zip(b['rates'], u['rates'])]!r}; "
              f"host ms per step the balanced run adds outside its balance "
              f"checks {(per_chunk(b, 'plain', 0) - per_chunk(u, 'plain', 0)) / chunk!r}"
              f" (device timeline "
              f"{(per_chunk(b, 'plain', 1) - per_chunk(u, 'plain', 1)) / chunk!r}); "
              f"a re-cut in the run adds {per_chunk(b, 'recut', 0) - per_chunk(b, 'plain', 0)!r}"
              f" host ms to its chunk, a check that keeps the geometry "
              f"{per_chunk(b, 'check', 0) - per_chunk(b, 'plain', 0)!r}; rebin "
              f"with K6 on the host clock {b['rebin_host']!r} (x_edges) / "
              f"{u['rebin_host']!r} ms; K2 {b['pass_a']!r} / {u['pass_a']!r} "
              f"ms, K6 with x_edges {b['move']!r} ms vs uniform K6 "
              f"{u['move']!r} ms vs plain walk {b['move_plain']!r} ms [{card}]")
    # the 2D vortex (K2 solid-free periodic, K5 periodic) and the balanced 3D
    # blob (K3 solid-free, K7 with x_edges on the periodic grid)
    state, params, spec, _ = taylor_green2d.build(TGV2D_N, device=dev)
    state = setup(state, params, spec, dt=taylor_green2d.timestep(TGV2D_N))
    t_tgv2d = speed(f"2D Taylor-Green vortex N={TGV2D_N}", "tgv2d", TGV2D_N,
                    state, params, spec, pair_cuda.pass_a_2d_rowloop,
                    rebin_cuda.rebin_move_2d)
    del state
    state, params, spec, _ = drift_blob.build(BLOB3D_S, True, True, device=dev,
                                              nz_cells=BLOB3D_NZ)
    state = setup(state, params, spec, dt=drift_blob.timestep(BLOB3D_S))
    t_blob3d = speed(f"3D drifting blob s={BLOB3D_S} balanced, with "
                     f"fix_balance", "blob3d", BLOB3D_S, state, params, spec,
                     pair_cuda.pass_a_3d, rebin_cuda.rebin_move_3d)
    del state
    print(f"[speed] {_nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}"
          f" (clocks.sm, power.draw, power.limit, temperature after the runs)")

    # -- 11. profile: where one chunk spends device time -------------------
    from torch.profiler import ProfilerActivity, profile

    sb = BLOB_S[1]
    targets = [(f"lid_cavity3d N={N}",
                lambda N=N: lid_cavity3d.build(N=N, device=dev), 1e-4,
                (("K3", "pass_a_3d_"), ("K7", "rebin_move_3d_kernel")))
               for N in CAVITY3D_N]
    # the spanwise-periodic cavity beside the walled one at the same sizes:
    # K3 and K7 with and without a periodic axis
    targets += [(f"spanwise-periodic cavity N={N}",
                 lambda N=N: lid_cavity3d.build_spanwise(N, device=dev), 1e-4,
                 (("K3 periodic", "pass_a_3d_"),
                  ("K7 periodic", "rebin_move_3d_kernel")))
                for N in SPAN_N]
    # the cavity beside the convection on the same grids: K1 without and
    # with its species rows, and the ops the three fixes and the species
    # half-steps add to a step
    targets += [(f"cavity N={N}",
                 lambda N=N, dt=dt: lid_cavity.build(N=N, dt=dt, device=dev), dt,
                 (("K1", "pa2d::window_"), ("K5", "rebin_move_2d_kernel")))
                for N, dt in zip(CAVITY_N, (1e-4, 5e-6))]
    # (rebinning every 10 steps, not the model's 50, so that a profiled
    # chunk stays short)
    targets += [(f"natural convection N={N}",
                 lambda N=N: natural_convection.build(N=N, dt=CONV_DT[N],
                                                      rebin_every=10,
                                                      device=dev), CONV_DT[N],
                 (("K1 species", "pa2d::window_"),
                  ("K5", "rebin_move_2d_kernel"))) for N in CONV_N]
    # and with the noise on: the thermal rows add no device op to a step
    targets += [(f"natural convection N={N} with thermal=True",
                 lambda N=N: _with_noise(natural_convection.build(
                     N=N, dt=CONV_DT[N], rebin_every=10, device=dev)),
                 CONV_DT[N],
                 (("K1 species/thermal", "pa2d::window_"),
                  ("K5", "rebin_move_2d_kernel"))) for N in CONV_N]
    # the 3D FSI beam at nx=60 (released at once, so K3's elastic terms run
    # on a moving beam) and the vortex at N=100: K3's elastic and solid-free
    # instantiations and K7 past cap 64
    targets += [(f"3D FSI beam nx={FSI3D_NX[1]}",
                 lambda: fsi.build_spanwise(FSI3D_NX[1], tdamp_solid=0,
                                            rebin_every=20, device=dev), 1e-8,
                 (("K3 mechanics/elastic", "pass_a_3d_"),
                  ("K7 large cap", "rebin_move_3d_kernel"))),
                (f"Taylor-Green vortex N={TGV_N[1]}",
                 lambda: taylor_green3d.build(TGV_N[1], device=dev),
                 taylor_green3d.timestep(TGV_N[1]),
                 (("K3 solid-free", "pass_a_3d_"),
                  ("K7 large cap", "rebin_move_3d_kernel")))]
    # cell polarization, rebinning every 20 steps so that a profiled chunk
    # stays short
    targets += [(f"cell polarization nx={nx}",
                 lambda nx=nx: cell_polarization.build(
                     nx=nx, dt=POLAR_DT[nx], rebin_every=20, device=dev),
                 POLAR_DT[nx],
                 (("K2 species/fsi", "pass_a_2d_rowloop_kernel"),
                  ("K6 periodic y", "rebin_move_2d_kernel")))
                for nx in POLAR_NX]
    # K2's and K3's thermal instantiations beside the targets above (the
    # models' e is 0, so the rows do all their work and add no force)
    targets += [(f"cell polarization nx={POLAR_NX[0]} with thermal=True",
                 lambda: _with_noise(cell_polarization.build(
                     nx=POLAR_NX[0], dt=POLAR_DT[POLAR_NX[0]], rebin_every=20,
                     device=dev)), POLAR_DT[POLAR_NX[0]],
                 (("K2 species/fsi/thermal", "pass_a_2d_rowloop_kernel"),
                  ("K6 periodic y", "rebin_move_2d_kernel"))),
                (f"lid_cavity3d N={CAVITY3D_N[0]} with thermal=True",
                 lambda: _with_noise(lid_cavity3d.build(N=CAVITY3D_N[0],
                                                        device=dev)), 1e-4,
                 (("K3 thermal", "pass_a_3d_"),
                  ("K7", "rebin_move_3d_kernel")))]
    # the blob, balanced and uniform, over two chunks without a re-cut (a
    # chunk of 5 steps is too short to show the pass-A mix)
    targets += [(
        f"drifting blob s={sb} {'balanced' if bal else 'uniform'}",
        lambda bal=bal: drift_blob.build(sb, balance=bal, device=dev),
        drift_blob.timestep(sb),
        (("K2 solid-free", "pass_a_2d_rowloop_kernel"),
         ("K6", "rebin_move_2d_kernel"))) for bal in (True, False)]
    # the 2D vortex and the balanced 3D blob
    targets += [(f"2D Taylor-Green vortex N={TGV2D_N}",
                 lambda: taylor_green2d.build(TGV2D_N, device=dev),
                 taylor_green2d.timestep(TGV2D_N),
                 (("K2 solid-free periodic", "pass_a_2d_rowloop_kernel"),
                  ("K5 periodic", "rebin_move_2d_kernel"))),
                (f"3D drifting blob s={BLOB3D_S} balanced",
                 lambda: drift_blob.build(BLOB3D_S, balance=True, device=dev,
                                          nz_cells=BLOB3D_NZ),
                 drift_blob.timestep(BLOB3D_S),
                 (("K3 solid-free", "pass_a_3d_"),
                  ("K7 x_edges periodic", "rebin_move_3d_kernel")))]
    profiled = {}  # (target, kernel) -> device ms per call
    for label, build, dt, kernels in targets:
        state, params, spec, _ = build()
        steps = max(spec.rebin_every, 10)
        state = simulate(setup(state, params, spec, dt=dt), params, spec,
                         steps)  # warm-up
        torch.cuda.synchronize()

        def us(name=""):
            return sum(e.self_device_time_total for e in on_card if name in e.key)

        def count(name=""):
            return sum(e.count for e in on_card if name in e.key)

        # every kernel named must show: a window whose records the profiler
        # lost (PERF.md) is profiled again, at most twice
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state = simulate(state, params, spec, steps)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            on_card = [e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            missing = [k for k, n in kernels if count(n) == 0]
            if not missing:
                break
        else:
            raise AssertionError(f"[profile] {label}: torch.profiler recorded "
                                 f"no {missing} activity on the card in 3 "
                                 f"windows of {steps} steps")
        print(f"[profile] {label}, {steps} steps under torch.profiler: "
              f"{count() / steps!r} device ops per step ({count('DtoH') / steps!r}"
              f" device-to-host copies), device time "
              f"{us() / steps / 1e3!r} ms per step (busy share "
              f"{us() / wall_us!r} of the profiled steps' wall time); "
              + ", ".join(f"{k} {us(n) / max(count(n), 1) / 1e3!r} ms per call "
                          f"x {count(n)}" for k, n in kernels)
              + f" [{card}]")
        profiled.update({(label, k): us(n) / max(count(n), 1) / 1e3
                         for k, n in kernels})
        del state, prof
    # K2 elastic at the polarization's speed size: its [speed] and
    # [profile] numbers side by side
    nx = POLAR_NX[1]
    tp = t_polar[nx]
    print(f"[speed] K2 elastic (fsi style, one species, periodic x and y), "
          f"cell polarization nx={nx}: {tp['pass_a']!r} ms per call as called, "
          f"{profiled[f'cell polarization nx={nx}', 'K2 species/fsi']!r} ms of "
          f"device time per call ([profile]), {tp['launches']} launches in its "
          f"timed run of {SPEED_STEPS['polarization'][nx][0]} steps, bound "
          f"{tp['pass_a_bound']} ({tp['pass_a_work']}), plain pass A "
          f"{tp['pass_a_plain']!r} [{card}]")

    # each kernel at its main path's size: the cavity N=200, FSI nx=60, the
    # 3D cavity N=100, the s=20 balanced blob, the convection N=200, the
    # polarization nx=100; the x_edges variants of K5 and
    # K7 at the cavities' sizes, their launches from the short edged runs
    blob_t = t_blob[BLOB_S[1], True]
    rows = (
        ("pass_a_2d", "csrc/pass_a_2d.cu", "ops/pair_pallas.py:308",
         cav_launches["pass_a_2d"], k1_abs, t_cav[CAVITY_N[0]], "pass_a"),
        ("pass_a_2d_rowloop", "csrc/pass_a_2d_rowloop.cu",
         "ops/pair_pallas.py:527", fsi_launches["pass_a_2d_rowloop"], k2_abs,
         t_fsi[FSI_NX[0]], "pass_a"),
        ("pass_a_3d", "csrc/pass_a_3d.cu", "ops/pair_pallas.py:1106",
         c3_launches["pass_a_3d"], k3_abs, t_c3[CAVITY3D_N[1]], "pass_a"),
        ("rebin_move_2d", "csrc/rebin_move_2d.cu", "core/rebin_pallas.py:202",
         cav_launches["rebin_move_2d"], k5_abs, t_cav[CAVITY_N[0]], "move"),
        ("rebin_move_2d_gated", "csrc/rebin_move_2d.cu",
         "core/rebin_pallas.py:346", fsi_launches["rebin_move_2d_gated"],
         k6_abs, t_fsi[FSI_NX[0]], "move"),
        ("rebin_move_3d", "csrc/rebin_move_3d.cu", "core/rebin_pallas.py:441",
         c3_launches["rebin_move_3d"], k7_abs, t_c3[CAVITY3D_N[1]], "move"),
        ("pass_a_2d_rowloop (solid-free)", "csrc/pass_a_2d_rowloop.cu",
         "ops/pair_pallas.py:527", blob_launches["pass_a_2d_rowloop"],
         k2sf_abs, blob_t, "pass_a"),
        ("rebin_move_2d (x_edges)", "csrc/rebin_move_2d.cu",
         "core/rebin_pallas.py:328", k5e_launches, k5e_abs, t_k5e, "move"),
        ("rebin_move_2d_gated (x_edges)", "csrc/rebin_move_2d.cu",
         "core/rebin_pallas.py:328", blob_launches["rebin_move_2d_gated"],
         k6e_abs, blob_t, "move"),
        ("rebin_move_3d (x_edges)", "csrc/rebin_move_3d.cu",
         "core/rebin_pallas.py:595", k7e_launches, k7e_abs, t_k7e, "move"),
        # with the species rows: K1 at the convection's N=200 (its main
        # path's launches), K3 at the 3D cavity's N=40 with one seeded
        # species (its launches from the 10-step seeded run)
        ("pass_a_2d (species)", "csrc/pass_a_2d.cu", "ops/pair_pallas.py:308",
         conv_launches["pass_a_2d"], k1s_abs, t_conv[CONV_N[0]], "pass_a"),
        ("pass_a_3d (species)", "csrc/pass_a_3d.cu", "ops/pair_pallas.py:1106",
         k3s_launches, k3s_abs, t_k3s, "pass_a"),
        # the polarization path at nx=100: K2 with the fsi pair style, one
        # species and both axes periodic, K6 with a periodic y axis
        ("pass_a_2d_rowloop (species/fsi, periodic y)",
         "csrc/pass_a_2d_rowloop.cu", "ops/pair_pallas.py:527",
         polar_launches["pass_a_2d_rowloop"], k2p_abs, t_polar[POLAR_NX[0]],
         "pass_a"),
        ("rebin_move_2d_gated (periodic y)", "csrc/rebin_move_2d.cu",
         "core/rebin_pallas.py:346", polar_launches["rebin_move_2d_gated"],
         k6p_abs, t_polar[POLAR_NX[0]], "move"),
        # the thermal rows: K1 on the thermal convection's main path at
        # N=200, K2 on the polarization at nx=100 and K3 on the 3D cavity at
        # N=40, each with its launches from a 10-step run with the noise
        ("pass_a_2d (thermal)", "csrc/pass_a_2d.cu", "ops/pair_pallas.py:308",
         th_launches["pass_a_2d"], k1t_abs, t_conv_thermal[CONV_N[0]],
         "pass_a"),
        ("pass_a_2d_rowloop (thermal)", "csrc/pass_a_2d_rowloop.cu",
         "ops/pair_pallas.py:527", k2t_launches, k2t_abs, t_k2t, "pass_a"),
        ("pass_a_3d (thermal)", "csrc/pass_a_3d.cu", "ops/pair_pallas.py:1106",
         k3t_launches, k3t_abs, t_k3t, "pass_a"),
        # periodic axes: K3 and K7 on the spanwise cavity's main path at
        # N=100 (y periodic), their errors the worst of the parity phases
        # (spanwise, the x-z channel, the fully periodic box)
        ("pass_a_3d (periodic)", "csrc/pass_a_3d.cu", "ops/pair_pallas.py:1147",
         span_launches["pass_a_3d"], k3p_abs, t_span[SPAN_N[1]], "pass_a"),
        ("rebin_move_3d (periodic)", "csrc/rebin_move_3d.cu",
         "core/rebin_pallas.py:584", span_launches["rebin_move_3d"], k7p_abs,
         t_span[SPAN_N[1]], "move"),
        # K3's mechanics, fsi and solid-free paths: the launches, the error
        # on the final state and the timing of the 3D FSI beam's main path
        # (nx=60), of the fsi style's 10-step seeded run at nx=30, and of
        # the vortex's main path (N=100); K7 past cap 64 on the beam's main
        # path (cap 296)
        ("pass_a_3d (mechanics/elastic)", "csrc/pass_a_3d.cu",
         "ops/pair_pallas.py:1106", f3_launches["pass_a_3d"], k3m_main_abs,
         t_fsi3d[FSI3D_NX[1]], "pass_a"),
        ("pass_a_3d (fsi)", "csrc/pass_a_3d.cu", "ops/pair_pallas.py:1106",
         k3f_launches, k3f_abs, t_k3f, "pass_a"),
        ("pass_a_3d (solid-free)", "csrc/pass_a_3d.cu",
         "ops/pair_pallas.py:1106", tg_launches["pass_a_3d"], k3sf_abs,
         t_tgv[TGV_N[1]], "pass_a"),
        ("rebin_move_3d (large cap)", "csrc/rebin_move_3d.cu",
         "core/rebin_pallas.py:441", f3_launches["rebin_move_3d"], k7l_abs,
         t_fsi3d[FSI3D_NX[1]], "move"),
        # the rest of the grouped kernel: K4 on the main paths of the
        # flagship and of the mechanics cavity at GROUPED_N with
        # preshift_window (K4 is bitwise K1, so its error on the mechanics
        # cavity is K1's), K1's full body on the mechanics cavity's main
        # path; K1 on the FSI and polarization states (periodic, elastic: no
        # user path routes such a grid to the grouped kernel, so the
        # launches of its parity and timing calls on the FSI states; timed
        # on the seeded one) and solid-free (launches and time from the
        # crowded-cell grid's 10-step run and its last state)
        ("pass_a_2d_preshift", "csrc/pass_a_2d.cu",
         "ops/pair_pallas.py:848", pre_launches["pass_a_2d_preshift"], k4_abs,
         t_pre["K4"], "pass_a"),
        ("pass_a_2d_preshift (mechanics)", "csrc/pass_a_2d.cu",
         "ops/pair_pallas.py:848", k4m_launches["pass_a_2d_preshift"], k1m_abs,
         t_mech["K4"],
         "pass_a"),
        ("pass_a_2d (full body, mechanics)", "csrc/pass_a_2d.cu",
         "ops/pair_pallas.py:308", mech_launches["pass_a_2d"], k1m_abs,
         t_mech["K1"], "pass_a"),
        ("pass_a_2d (elastic/periodic)", "csrc/pass_a_2d.cu",
         "ops/pair_pallas.py:308", k1f_launches, k1f_abs, t_k1f, "pass_a"),
        ("pass_a_2d (solid-free)", "csrc/pass_a_2d.cu", "ops/pair_pallas.py:308",
         k1sf_launches["pass_a_2d"], k1sf_abs, t_k1sf, "pass_a"),
    )
    # K5 on both periodic axes and K7 with x_edges on the periodic grid on
    # their main paths (the 2D vortex at N=1000, the 3D blob at s=8), their
    # errors the worst of their parity phases
    rows += (
        ("rebin_move_2d (periodic)", "csrc/rebin_move_2d.cu",
         "core/rebin_pallas.py:370", tgv2d_launches["rebin_move_2d"], k5p_abs,
         t_tgv2d, "move"),
        ("rebin_move_3d (x_edges, periodic)", "csrc/rebin_move_3d.cu",
         "core/rebin_pallas.py:595", blob3d_launches["rebin_move_3d"],
         k7ep_abs, t_blob3d, "move"),
    )
    # no single PyTorch call computes pass A or the locality move
    kernels = [
        {"name": name, "route": "cuda", "source": f"sph_bvf_tpu_torch/{src}",
         "replaces": f"sph_bvf_tpu/{tpu}", "launches": launches,
         "max_abs_err": err, "ms": t[op], "plain_ms": t[f"{op}_plain"],
         "bound_ms": t[f"{op}_bound"][0], "bound_by": t[f"{op}_bound"][1],
         "library_ms": None}
        for name, src, tpu, launches, err, t, op in rows
    ]
    # K8: launches from the probe's entry point; torch.matmul(x.expand(g, R,
    # W), S) computes the mma variant's g products in one call
    kernels += [
        {"name": f"rotation_probe ({v})", "route": "cuda",
         "source": "sph_bvf_tpu_torch/csrc/rotation_probe.cu",
         "replaces": "tools/mxu_rotation_probe.py:97",
         "launches": k8_launches[f"probe_{v}"], "max_abs_err": k8[v]["err"],
         "ms": k8[v]["ms"], "plain_ms": k8[v]["plain"],
         "bound_ms": k8[v]["bound"][0], "bound_by": k8[v]["bound"][1],
         "library_ms": probe_out["matmul_ms"] if v == "mma" else None}
        for v in rp.VARIANTS
    ]
    print(f"[time] {time.perf_counter() - t_start!r} s from the first build "
          f"to here [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
