"""The whole step's share of the card's peak: the least time the span's
counted work could take (every pass-A call and every rebin move, at
``work``'s peaks) over the span's host-clock length.  It bounds the
pass-A and move rooflines' gains end to end: a kernel taken off the path
leaves its own share silent, never this one."""

from portbench import work


def read(rec):
    if not rec.get("busy_s") or not rec.get("pairs"):
        return None
    n, pairs, dim = rec["n_valid"], rec["pairs"], rec["dim"]
    filt = rec["span_filter_steps"]
    least = (filt * work.pass_a_bound(n, pairs, dim, True)[0]
             + (rec["span_steps"] - filt)
             * work.pass_a_bound(n, pairs, dim, False)[0]
             + rec["span_chunks"]
             * work.move_bound(n, dim, rec["n_species"])[0])
    return 100.0 * least / rec["window_s"]
