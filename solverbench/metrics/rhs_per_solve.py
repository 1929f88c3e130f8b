"""Engine coalescing: right-hand sides served per solver call over the
window, from the deltas of ``ServeStats``."""


def read(run):
    s = run.stats_delta
    calls = s["multi_rhs_groups"] + s["single_solves"] + s["vmap_batches"]
    rhs = s["multi_rhs_requests"] + s["single_solves"] + s["vmap_requests"]
    return rhs / calls if calls else None
