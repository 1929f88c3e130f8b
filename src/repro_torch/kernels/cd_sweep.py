"""One sweep of either solver: the CUDA kernels ``csrc/bak_sweep.cu``
(Algorithm 1) and ``csrc/bakp_sweep.cu`` (Algorithm 2), with their plain
torch versions.

Counterpart of ``repro.kernels.cd_sweep`` (``bak_row_update``,
``cd_sweep``, ``bakp_block_update``, ``bakp_sweep``).

``cd_sweep`` and ``bakp_sweep`` follow the device of the tensors they are
given: CPU tensors run the plain versions (``cd_sweep_plain``,
``bakp_sweep_plain``), CUDA tensors launch the kernels, and anything else
raises.  Both kernels split obs across CTAs on thread-block clusters: the
Algorithm-2 kernel in one of two regimes (``bakp_grid``,
``csrc/bakp_cluster.cuh``, whose plan the two whole-solve kernels share),
the Algorithm-1 kernel in one of four (``bak_grid``,
``csrc/bak_column.cuh``).
The JAX ``cd_sweep``
stages ``block`` rows per grid step and checks a VMEM budget; here
``block`` only has to divide vars (as in JAX), since the Algorithm-1 kernel
walks the columns one at a time whatever the block.

x is fp32 or bf16 (``check_kernel_args``), as the Pallas kernels load x in
its stored dtype and widen it to fp32: the plain versions widen one row or
block at a time, the kernels as they load, and every byte count of x in
the plans takes x's itemsize.  The residual, norms and increments are fp32.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# On-chip budget of the whole-solve kernel's working set, in bytes; replaces
# the JAX package's TPU figure ``VMEM_BUDGET_BYTES`` (64 MiB of VMEM).  The
# port's fused kernel keeps x's slices in shared memory where they fit and
# reads x through the L2 cache every sweep where they do not, so the
# budget is an L2 figure: 40 MiB, 80% of an H100's 50 MiB L2, leaving the
# rest to the residual traffic and other streams' lines (see PERF.md).  A
# fixed constant keeps dispatch deterministic on any host; ``fused_fits``
# reads it at call time, so tests may patch it.
ON_CHIP_BUDGET_BYTES = 40 * 1024 * 1024

# Shared memory the kernels may take for one block's increments (block·k
# fp32); an H100 block can use up to 227 KB.
SMEM_DA_LIMIT_BYTES = 200 * 1024

# Fewest obs one CTA of a multi-CTA launch owns.
MIN_OBS_PER_CTA = 128

# CTAs in a thread-block cluster of the Algorithm-1 kernels, from the sweep
# over {2, 4, 8, 16} at the phase 1 shapes (PERF.md); ``bak_grid`` reads it
# at call time.
BAK_CLUSTER = 16

# ``bak_plan``'s regimes and residual placements, by the codes it returns
# (csrc/bak_column.cuh).
BAK_REGIMES = ("single_cluster", "multi_cluster", "e_device", "x_device")
BAK_E_PLACES = ("device", "shared", "registers")

# CTAs in a thread-block cluster of each Algorithm-2 kernel, from the sweep
# over {4, 8, 16} at the phase shapes (PERF.md): the streaming solve
# is fastest on 7 clusters of 16, the per-sweep kernel on 15 of 8 (120
# CTAs pull x from device memory, not 112), the fused solve on 7 of 16;
# read at call time.
BAKP_CLUSTER = {"stream": 16, "sweep": 8, "fused": 16}

# Clusters of C CTAs an H100 SXM holds at once at one CTA per SM (measured,
# PERF.md): the plan's arithmetic where no card is asked (the fit
# predicates); on the card the wrapper asks the CUDA runtime.
CARD_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}

# CTAs of an Algorithm-2 grid at most: one per SM of an H100 SXM.
MAX_CTAS = 132

# Dynamic shared memory one CTA may use on an H100 (227 KB, opt-in).
SMEM_PER_CTA_BYTES = 232_448

# The Algorithm-2 plan's regimes, by the codes the kernels take
# (csrc/bakp_cluster.cuh).
BAKP_REGIMES = ("single_cluster", "multi_cluster")

# Where a block's tile of x comes from in an Algorithm-2 kernel, by the
# codes the whole-solve kernels take (csrc/bakp_solve.cuh): "shared", x's
# slice resident in shared memory for the whole launch (the fused kernel's
# x_shared regime); "ring", tiles copied through a shared-memory ring (the
# streaming kernel, the per-sweep kernel's ring of row chunks, and the
# fused kernel's x_l2 regime); "direct", read in place from the L2 with
# the residual (the fused kernel's x_l2 where no ring fits a CTA).
BAKP_X_IN = ("shared", "ring", "direct")

# Floats of a CTA's dynamic shared memory besides the exchange arrays
# (BAKP_HDR_FIXED), and the per-sweep kernel's ring: 3 to 8 stages of 32
# rows x at most 256 positions (SWEEP_* in csrc/bakp_sweep.cu); with e in
# device memory a stage also carries up to 8 rows of e (the partials' KC,
# ``sweep_ke``).
_HDR_FIXED = 60
_SWEEP_ROWS, _SWEEP_POS, _SWEEP_STAGES, _SWEEP_KE = 32, 256, (3, 8), 8
_SLICE_ALIGN = 32

# x's element types the kernels take (the other operands are fp32).
X_DTYPES = (torch.float32, torch.bfloat16)

_grid_cache: dict = {}
# Exchange words of the Algorithm-2 kernels by (device, stream): (words,
# the next launch's first tag).  Tags are 32 bits.  Lanes launch from
# several threads, each on its own stream: the table's read-and-replace
# runs under ``_xchg_lock``.
_xchg: dict = {}
_xchg_lock = threading.Lock()
_TAG_LIMIT = 1 << 32


def bak_row_update(xj: torch.Tensor, inv_j, e: torch.Tensor):
    """One Algorithm-1 column update on loaded values (plain torch).

    Args: xj (1, obs) column; inv_j its inverse squared norm; e (k, obs).
    Returns (da, e'): (1, k) increment and the corrected residual(s).
    """
    da = (xj @ e.T) * inv_j                               # <x_j, e>, (1, k)
    return da, e - da.T @ xj


def cd_sweep_plain(x_t, e2, inv_cn):
    """Plain version of the Algorithm-1 sweep kernel on the (k, obs)
    layout: returns (da (vars, k), e' (k, obs))."""
    nvars = x_t.shape[0]
    inv = inv_cn.reshape(nvars).float()
    e = e2.float()
    da = torch.empty((nvars, e.shape[0]), dtype=torch.float32,
                     device=x_t.device)
    for j in range(nvars):
        d, e = bak_row_update(x_t[j:j + 1].float(), inv[j], e)
        da[j] = d[0]
    return da, e


def bakp_block_update(xb: torch.Tensor, inv: torch.Tensor, e: torch.Tensor,
                      omega: float):
    """One Algorithm-2 block update on loaded values (plain torch).

    Args: xb (CB, obs) block; inv (CB, 1); e (k, obs); omega relaxation.
    Returns (da, e'): (CB, k) increments and the corrected residual(s).
    """
    g = xb @ e.T                                          # (CB, k)
    da = omega * g * inv
    return da, e - da.T @ xb


def bakp_sweep_plain(x_t, e2, inv_cn, *, block, omega=1.0):
    """Plain version of the sweep kernel on the (k, obs) layout: returns
    (da (vars, k), e' (k, obs))."""
    nvars = x_t.shape[0]
    inv = inv_cn.reshape(nvars, 1).float()
    e = e2.float()
    das = []
    for b in range(0, nvars, block):
        da, e = bakp_block_update(x_t[b:b + block].float(), inv[b:b + block],
                                  e, omega)
        das.append(da)
    return torch.cat(das), e


class BakpPlan(NamedTuple):
    """Launch plan of the Algorithm-2 cluster kernels (``bakp_plan``)."""
    regime: str         # one of BAKP_REGIMES
    ctas: int
    cluster: int        # CTAs per cluster
    clusters: int
    L: int              # obs positions a CTA owns (a multiple of 32)
    xchg_words: int     # int32 words of the cross-cluster exchange
    smem: int           # dynamic shared memory bytes a CTA carves
    e_in: str           # where the residual slices live: "shared"/"device"
    stages: int         # depth of the x ring (0: no ring)
    x_in: str           # where a block's tile comes from: one of BAKP_X_IN
    group: int          # right-hand sides a block step exchanges at once


def slice_len(obs: int, ctas: int) -> int:
    """Obs positions each of ``ctas`` CTAs owns (``bakp_slice_len``)."""
    length = -(-obs // ctas)
    return -(-length // _SLICE_ALIGN) * _SLICE_ALIGN


def bakp_kp(k: int) -> int:
    """k padded to 1, 2 or a multiple of 4: the row stride of a block's
    partials and increments in the kernels."""
    return k if k <= 2 else -(-k // 4) * 4


def bakp_own(block: int, k: int, cluster: int) -> int:
    """Floats of a block's partials each CTA of a cluster owns (a multiple
    of 4; ``bakp_own`` in the source)."""
    own = -(-block * bakp_kp(k) // cluster)
    return -(-own // 4) * 4


def bakp_exchange_bytes(block: int, k: int, cluster: int) -> int:
    """Shared memory of a CTA's exchange arrays (``bakp_hdr_floats``): the
    partials, their receive slots and the gathered increments (each C·S
    floats, S a CTA's owned slice), the owned slice, the mbarriers and the
    reduction scratch."""
    own = bakp_own(block, k, cluster)
    return 4 * (_HDR_FIXED + 3 * cluster * own + own)


def _cluster_size(cluster: int, max_ctas: "int | None") -> int:
    """``cluster`` halved until a cluster fits ``max_ctas`` CTAs."""
    cap = MAX_CTAS if max_ctas is None else max_ctas
    while cluster > 1 and cluster > cap:
        cluster >>= 1
    return cluster


def _clusters_held(size: int, max_ctas: "int | None",
                   max_clusters: "int | None") -> int:
    """Clusters of ``size`` CTAs a launch may take at most."""
    cap = MAX_CTAS if max_ctas is None else max_ctas
    fit = (CARD_CLUSTERS.get(size, MAX_CTAS // size)
           if max_clusters is None else max_clusters)
    return max(1, min(fit, cap // size))


def bakp_layout(obs: int, *, cluster: int, max_ctas: "int | None" = None,
                max_clusters: "int | None" = None):
    """``(regime, ctas, cluster, clusters, L)`` of an Algorithm-2 launch.

    One cluster of ``cluster`` CTAs (halved while a CTA would own
    fewer than ``MIN_OBS_PER_CTA`` obs) when obs needs no more CTAs; else
    as many clusters as obs wants at ``MIN_OBS_PER_CTA`` a CTA, at most
    ``max_ctas`` CTAs (default ``MAX_CTAS``) and at most ``max_clusters``
    clusters (default ``CARD_CLUSTERS``, what an H100 holds at once).  The
    cluster shrinks to fit ``max_ctas``.  A launch of one cluster is the
    single-cluster regime; the last CTAs may own empty slices."""
    size = _cluster_size(cluster, max_ctas)
    if obs <= size * MIN_OBS_PER_CTA:
        while size > 1 and size * MIN_OBS_PER_CTA > obs:
            size >>= 1
        n = 1
    else:
        want = -(-obs // MIN_OBS_PER_CTA)
        n = max(1, min(_clusters_held(size, max_ctas, max_clusters),
                       want // size))
    regime = BAKP_REGIMES[0] if n == 1 else BAKP_REGIMES[1]
    return regime, n * size, size, n, slice_len(obs, n * size)


def _more_ctas(obs: int, **layout):
    """``bakp_layout``'s launch, then every launch of more CTAs the card
    holds (one cluster more at a time), each with a shorter slice."""
    base = bakp_layout(obs, **layout)
    yield base
    size = _cluster_size(layout["cluster"], layout.get("max_ctas"))
    held = _clusters_held(size, layout.get("max_ctas"),
                          layout.get("max_clusters"))
    for n in range(1, held + 1):
        if n * size > base[1]:
            yield (BAKP_REGIMES[n > 1], n * size, size, n,
                   slice_len(obs, n * size))


def _group(block: int, k: int, cluster: int, room: int) -> int:
    """Most right-hand sides one exchange may carry within ``room`` bytes
    of exchange arrays, spread evenly over the groups k then takes; 0
    where not even one fits."""
    g = k
    while g > 0 and bakp_exchange_bytes(block, g, cluster) > room:
        g -= 1
    return g and -(-k // -(-k // g))


def _fused_plan(obs: int, k: int, block: int, nvars: int, itemsize: int,
                layout) -> BakpPlan:
    """The whole-solve kernel's plan, for x of ``itemsize`` bytes an
    element: x's slice resident in shared memory
    (``x_in`` "shared") where it, the residual slice and one exchange of at
    least one right-hand side fit ``SMEM_PER_CTA_BYTES`` on some launch of
    ``_more_ctas``; else each block's tile through the two-stage ring
    ("ring") where that fits; else x and the residual read in place
    ("direct") on ``bakp_layout``'s launch.  Of the launches that fit, the
    one whose exchanges carry the most right-hand sides (the fewest groups),
    then the fewest CTAs.  Raises where one right-hand side's exchange
    arrays alone overflow a CTA."""
    for x_in, per_pos in (("shared", itemsize * nvars + 4 * k),
                          ("ring", itemsize * 2 * block + 4 * k),
                          ("direct", 0)):
        layouts = (_more_ctas(obs, **layout) if x_in != "direct"
                   else [bakp_layout(obs, **layout)])
        best, best_group = None, 0
        for lay in layouts:
            group = _group(block, k, lay[2],
                           SMEM_PER_CTA_BYTES - per_pos * lay[4])
            if group > best_group:
                best, best_group = lay, group
        if best is not None:
            regime, ctas, size, n, length = best
            own = bakp_own(block, best_group, size)
            smem = bakp_exchange_bytes(block, best_group, size)
            return BakpPlan(
                regime, ctas, size, n, length,
                0 if n == 1 else 4 * n * (size * own + 2),
                smem + per_pos * length,
                "device" if x_in == "direct" else "shared",
                2 if x_in == "ring" else 0, x_in, best_group)
    raise ValueError(
        f"fused_solve: one right-hand side's exchange arrays at block "
        f"{block} take {bakp_exchange_bytes(block, 1, layouts[0][2])} bytes "
        f"of shared memory a CTA, over {SMEM_PER_CTA_BYTES}; reduce block")


def bakp_plan(kind: str, obs: int, k: int, block: int, *, nvars: int = 0,
              itemsize: int = 4, **layout) -> BakpPlan:
    """The launch plan of ``kind`` ("stream", "sweep" or "fused") on
    ``bakp_layout`` (its keywords; the cluster defaults to
    ``BAKP_CLUSTER[kind]``), for x of ``itemsize`` bytes an element (4
    fp32, 2 bf16), with the shared memory a CTA carves: the exchange
    arrays, then for "stream" the two-stage tile ring and the residual
    slice; for "sweep" the residual slice when it fits
    ``SMEM_PER_CTA_BYTES`` beside a ring of three chunks, and a ring of as
    many chunks as then fit, three to eight (with the slice in device
    memory, each chunk also carries its rows of e, and the update's k x P
    tile comes first: ``sweep_smem_floats``); for "fused" (a design of
    ``nvars`` rows) as ``_fused_plan`` picks."""
    layout.setdefault("cluster", BAKP_CLUSTER[kind])
    if kind == "fused":
        return _fused_plan(obs, k, block, nvars, itemsize, layout)
    regime, ctas, size, n, length = bakp_layout(obs, **layout)
    smem = bakp_exchange_bytes(block, k, size)
    e_bytes = 4 * k * length
    if kind == "stream":
        smem += itemsize * 2 * block * length + e_bytes
        e_in, stages = "shared", 2
    else:
        lo, hi = _SWEEP_STAGES
        pos = min(length, _SWEEP_POS)
        stage = itemsize * _SWEEP_ROWS * pos
        room = SMEM_PER_CTA_BYTES - smem
        e_in = "shared" if room - e_bytes >= lo * stage else "device"
        if e_in == "shared":
            fixed = e_bytes
        else:      # each chunk's rows of e beside its x; the update's tile
            fixed = 4 * k * pos
            stage += 4 * min(k, _SWEEP_KE) * pos
        room -= fixed
        smem += fixed
        stages = max(lo, min(hi, room // stage))
        smem += stages * stage
    # Two parities x clusters x (C·S step words + 2 SSE words), 64 bits each.
    words = 0 if n == 1 else 4 * n * (size * bakp_own(block, k, size) + 2)
    return BakpPlan(regime, ctas, size, n, length, words, smem, e_in, stages,
                    "ring", k)


def bakp_grid(lib_fn, kind: str, obs: int, k: int, block: int, *,
              nvars: int = 0, itemsize: int = 4) -> BakpPlan:
    """``bakp_plan`` on the current card: the clusters it holds at once
    come from the CUDA runtime (``lib_fn``, a ``*_clusters`` entry), its
    SM count caps the CTAs.  Raises if the card cannot place one cluster."""
    dev = torch.cuda.current_device()
    size = BAKP_CLUSTER[kind]
    key = (lib_fn.__name__, dev, obs, k, block, nvars, itemsize, size,
           SMEM_PER_CTA_BYTES)
    if key not in _grid_cache:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = bakp_plan(kind, obs, k, block, nvars=nvars, itemsize=itemsize,
                         cluster=size, max_ctas=sms)
        out = ctypes.c_int(0)
        _build.check(lib_fn(plan.group, plan.cluster, plan.smem,
                            ctypes.addressof(out)), lib_fn.__name__)
        if out.value < 1:
            raise _build.KernelError(
                f"{lib_fn.__name__}: the card holds no cluster of "
                f"{plan.cluster} CTAs with {plan.smem} bytes of shared "
                f"memory each")
        _grid_cache[key] = bakp_plan(kind, obs, k, block, nvars=nvars,
                                     itemsize=itemsize, cluster=size,
                                     max_ctas=sms, max_clusters=out.value)
    return _grid_cache[key]


def bakp_exchange(plan: BakpPlan, device, tags: int):
    """Cross-cluster exchange words for one launch of ``plan`` on the
    current stream, and the tag its steps count from: ``(None, 0)`` for
    one cluster.  A launch may use ``tags`` tags.  Launches on one stream
    share its words, each launch's tags past every earlier one's, so no
    word left from an earlier launch passes a wait; the words are zeroed
    only when they are made, grow, or the 32-bit tags would wrap."""
    if plan.xchg_words == 0:
        return None, 0
    if tags >= _TAG_LIMIT:
        raise ValueError(f"a launch of {tags} exchange steps overflows the "
                         f"kernels' 32-bit tags")
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    with _xchg_lock:
        words, tag0 = _xchg.get(key, (None, 0))
        if (words is None or words.numel() < plan.xchg_words
                or tag0 + tags >= _TAG_LIMIT):
            size = max(plan.xchg_words,
                       0 if words is None else words.numel())
            words, tag0 = torch.zeros((size,), dtype=torch.int32,
                                      device=device), 0
        _xchg[key] = (words, tag0 + tags)
    return words, tag0


class BakPlan(NamedTuple):
    """Launch plan of the Algorithm-1 kernels (``bak_plan``)."""
    regime: str         # one of BAK_REGIMES
    ctas: int
    cluster: int        # CTAs per cluster
    clusters: int
    e_in: str           # where the residual slices live: BAK_E_PLACES
    xchg_words: int     # int32 words of the cross-cluster exchange


def bak_grid(lib_fn, obs: int, k: int, itemsize: int = 4) -> BakPlan:
    """Launch plan of the Algorithm-1 kernels (``lib_fn``, a ``*_grid``
    entry, for an x of ``itemsize`` bytes an element, whose ring it
    carves): one cluster of ``BAK_CLUSTER`` CTAs (fewer for small obs) when
    the residual slices and the x ring fit it, else clusters of
    ``BAK_CLUSTER`` CTAs, one CTA per SM and at least ``MIN_OBS_PER_CTA``
    obs each, with the residual slices on chip when they fit and in device
    memory otherwise (``e_device``), and x read from device memory too
    where even the x ring does not fit a CTA (``x_device``).  On chip means
    registers for k <= 8 and at most 12 positions a thread, else shared
    memory."""
    cluster = BAK_CLUSTER
    key = (lib_fn.__name__, torch.cuda.current_device(), obs, k, cluster,
           itemsize)
    if key not in _grid_cache:
        out = (ctypes.c_int * 6)()
        _build.check(lib_fn(obs, k, MIN_OBS_PER_CTA, cluster, itemsize,
                            ctypes.addressof(out)), lib_fn.__name__)
        _grid_cache[key] = BakPlan(BAK_REGIMES[out[0]], out[1], out[2],
                                   out[3], BAK_E_PLACES[out[4]], out[5])
    return _grid_cache[key]


def bak_exchange(plan: BakPlan, device) -> "torch.Tensor | None":
    """Zeroed cross-cluster exchange slots for one launch (None for one
    cluster): a sequence number left from an earlier launch would pass the
    kernel's wait."""
    if plan.xchg_words == 0:
        return None
    return torch.zeros((plan.xchg_words,), dtype=torch.int32, device=device)


def check_kernel_args(x_t: torch.Tensor, nrhs: int, block: int, *tensors):
    """What the CUDA kernels take: a contiguous fp32 or bf16 x_t (the
    other operands fp32) on one device with every other operand, vars a
    multiple of block, and one block's increments within shared memory
    (``block=1`` for the Algorithm-1 kernels, which hold one column's k
    increments)."""
    if x_t.dtype not in X_DTYPES:
        raise TypeError(f"the CUDA kernels take fp32 or bf16 x_t, got "
                        f"{x_t.dtype}")
    if not x_t.is_contiguous():
        raise ValueError("x_t must be contiguous (vars, obs)")
    if x_t.shape[0] % block:
        raise ValueError(
            f"vars ({x_t.shape[0]}) must be a multiple of block ({block})")
    for t in tensors:
        if t is not None and t.device != x_t.device:
            raise ValueError(f"operands on {t.device} and {x_t.device}")
    if block * nrhs * 4 > SMEM_DA_LIMIT_BYTES:
        raise ValueError(
            f"block·k = {block}·{nrhs} increments exceed the kernels' "
            f"{SMEM_DA_LIMIT_BYTES} bytes of shared memory; reduce block or "
            f"split the right-hand sides")


def _bakp_sweep_cuda(x_t, e2, inv_cn, *, block, omega):
    """The per-sweep kernel; where a CTA's shared memory cannot hold every
    right-hand side's exchange arrays (large block·k), one launch per group
    of right-hand sides: Algorithm 2 updates each column of e on its own,
    so the groups compute what one launch would."""
    nvars, obs = x_t.shape
    nrhs = e2.shape[0]
    check_kernel_args(x_t, nrhs, block, e2, inv_cn)
    group = nrhs
    while group > 1 and (bakp_plan("sweep", obs, group, block,
                                   itemsize=x_t.element_size()).smem
                         > SMEM_PER_CTA_BYTES):
        group = -(-group // 2)
    e_in = e2.float().contiguous()
    inv = inv_cn.float().contiguous()
    if group == nrhs:
        return _bakp_sweep_launch(x_t, e_in, inv, block, omega)
    parts = [_bakp_sweep_launch(x_t, e_in[r:r + group].contiguous(), inv,
                                block, omega)
             for r in range(0, nrhs, group)]
    return (torch.cat([d for d, _ in parts], 1),
            torch.cat([e for _, e in parts], 0))


def _bakp_sweep_launch(x_t, e_in, inv, block, omega):
    nvars, obs = x_t.shape
    nrhs = e_in.shape[0]
    lib = _build.load("bakp_sweep")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = bakp_grid(lib.bakp_sweep_clusters, "sweep", obs, nrhs, block,
                         itemsize=x_t.element_size())
        if plan.smem > SMEM_PER_CTA_BYTES:
            raise ValueError(
                f"bakp_sweep: block·k = {block}·{nrhs} needs {plan.smem} "
                f"bytes of shared memory a CTA, over {SMEM_PER_CTA_BYTES}")
        e_out = torch.empty_like(e_in)
        da = torch.empty((nvars, nrhs), dtype=torch.float32, device=dev)
        xchg, tag0 = bakp_exchange(plan, dev, nvars // block)
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = _build.launch_key("bakp_sweep", x_t.element_size())
        _build.check(lib.bakp_sweep_launch(
            x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
            e_in.data_ptr(), e_out.data_ptr(), da.data_ptr(),
            None if xchg is None else xchg.data_ptr(), tag0,
            nvars, obs, nrhs, block, float(omega),
            BAKP_REGIMES.index(plan.regime), plan.ctas, plan.cluster,
            int(plan.e_in == "shared"), plan.stages, plan.smem, stream),
        "bakp_sweep_launch")
        _build.count_launch(key, plan)
    return da, e_out


def _cd_sweep_cuda(x_t, e2, inv_cn):
    nvars, obs = x_t.shape
    nrhs = e2.shape[0]
    check_kernel_args(x_t, nrhs, 1, e2, inv_cn)
    lib = _build.load("bak_sweep")
    dev = x_t.device
    with torch.cuda.device(dev):
        plan = bak_grid(lib.bak_sweep_grid, obs, nrhs, x_t.element_size())
        e_in = e2.float().contiguous()
        inv = inv_cn.float().contiguous()
        e_out = torch.empty_like(e_in)
        da = torch.empty((nvars, nrhs), dtype=torch.float32, device=dev)
        xchg = bak_exchange(plan, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        key = _build.launch_key("bak_sweep", x_t.element_size())
        _build.check(lib.bak_sweep_launch(
            x_t.data_ptr(), x_t.element_size(), inv.data_ptr(),
            e_in.data_ptr(), e_out.data_ptr(), da.data_ptr(),
            None if xchg is None else xchg.data_ptr(), nvars,
            obs, nrhs, BAK_REGIMES.index(plan.regime), plan.ctas,
            plan.cluster, stream), "bak_sweep_launch")
        _build.count_launch(key, plan)
    return da, e_out


def _sweep(name, plain, cuda, x_t, e, inv_cn, block_of, **kw):
    """Shared wrapper of the two sweeps: shape checks (vars a multiple of
    ``block_of``), the 1-D ``e`` form and the device rule."""
    nvars, obs = x_t.shape
    if nvars % block_of:
        raise ValueError(
            f"vars ({nvars}) must be a multiple of block ({block_of})")
    single = e.dim() == 1
    e2 = e.reshape(1, obs) if single else e
    if x_t.device.type == "cpu":
        da, e_out = plain(x_t, e2, inv_cn, **kw)
    elif x_t.device.type == "cuda":
        da, e_out = cuda(x_t, e2, inv_cn, **kw)
    else:
        raise ValueError(f"{name} runs on cpu or cuda, not {x_t.device}")
    if single:
        return da[:, 0], e_out[0]
    return da, e_out


def cd_sweep(x_t, e, inv_cn, *, block=256):
    """One paper-faithful Algorithm-1 sweep, strictly in column order.

    Args:
      x_t: (vars, obs) transposed design; vars a multiple of ``block``.
      e: (obs,) residual, or (k, obs) for k right-hand sides.
      inv_cn: (vars,) inverse squared column norms.
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    return _sweep("cd_sweep", cd_sweep_plain, _cd_sweep_cuda, x_t, e, inv_cn,
                  block)


def bakp_sweep(x_t, e, inv_cn, *, block=256, omega=1.0):
    """One SolveBakP (block-Jacobi) sweep over every column block.

    Args:
      x_t: (vars, obs) transposed design; vars a multiple of ``block``.
      e: (obs,) residual, or (k, obs) for k right-hand sides.
      inv_cn: (vars,) inverse squared column norms.
    Returns:
      (da, e'): (vars,)/(obs,) for 1-D ``e``, (vars, k)/(k, obs) otherwise.
    """
    return _sweep("bakp_sweep", bakp_sweep_plain, _bakp_sweep_cuda, x_t, e,
                  inv_cn, block, block=block, omega=omega)
