"""Kernels: the window's solves' least time over the device's busy time.

Each solve's least time is the larger of its bytes over the memory's peak
rate and its FLOP over the fp32 peak, counted from its shape, k and sweeps
alone (``work/<method>.py``), whatever kernel ran it.  The kernel time is
the union of the kernels' intervals in the trace (copies and fills left
out).  Nothing to read without a trace, a device of known peaks, a kernel
or a solve."""


def read(run):
    if run.trace is None or run.peaks is None or run.trace.kernel_s <= 0:
        return None
    if not run.solves:
        return None
    least = 0.0
    for s in run.solves:
        nbytes, flops = run.work(s.obs, s.nvars, s.k, s.n_sweeps, s.itemsize,
                                 run.peaks["l2_bytes"])
        least += max(nbytes / run.peaks["hbm_bytes_per_s"],
                     flops / run.peaks["fp32_flops_per_s"])
    return 100.0 * least / run.trace.kernel_s
