"""The load generator: a closed loop of clients over the dispatcher.

Each client holds one request at a time and sends its next one as soon as
its reply is back: a caller that waits for its coefficients, such as a
fitting job or a probe sweep.  One thread drives every client.  It waits
on the outstanding tickets in the order they were sent (a fired batch
completes its tickets together, so this order is the order replies come
back) and stamps each reply on the harness's own clock when it sees it.

A mix (``traffic/<mix>.json``) gives ``designs`` designs with
``clients_per_design`` clients each, each client picking right-hand sides
from its design's pool in an order drawn from the seed, and the solver
knobs every request carries (``method``, ``thr``, ``rtol``, ``max_iter``;
the precision is the configuration's).
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from harness.inputs import Design, client_rng

clock = time.perf_counter

#: How long past the window's close a reply is waited for before the
#: request counts as never answered.
GRACE_S = 60.0


@dataclass
class Done:
    """One request sent in the window, and what came back."""

    design: int
    pool_idx: int
    t_submit: float
    t_done: float
    coef: Optional[np.ndarray]     # None when no answer came or it failed
    error: Optional[str]
    queue_wait_s: Optional[float] = None
    fired_at: Optional[float] = None
    solve_s: Optional[float] = None
    n_sweeps: Optional[int] = None
    group_size: Optional[int] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


@dataclass
class _Client:
    design: int
    rng: np.random.Generator


@dataclass
class _Pending:
    client: _Client
    pool_idx: int
    ticket: object
    t_submit: float


class ClosedLoop:
    """Clients over ``dispatcher``; ``make_request(design, pool_idx)``
    builds one request.  ``span(name)`` wraps each call into the program
    (``sb.submit``, ``sb.result_wait``) so a trace can name what the host
    was doing."""

    def __init__(self, dispatcher, designs: List[Design], traffic: dict,
                 seed: int, make_request: Callable,
                 span: Callable = lambda name: contextlib.nullcontext()):
        self.dispatcher = dispatcher
        self.make_request = make_request
        self.span = span
        if traffic.get("loop") != "closed":
            raise ValueError(f"traffic loop {traffic.get('loop')!r}: this "
                             f"generator drives closed loops")
        per = int(traffic["clients_per_design"])
        self.pool = int(traffic["rhs_pool"])
        self.clients = [_Client(d, client_rng(seed, d * per + c))
                        for d in range(len(designs)) for c in range(per)]

    def _send(self, client: _Client) -> _Pending:
        idx = int(client.rng.integers(self.pool))
        req = self.make_request(client.design, idx)
        t0 = clock()
        with self.span("sb.submit"):
            ticket = self.dispatcher.submit(req)
        return _Pending(client, idx, ticket, t0)

    def run(self, *, seconds: Optional[float] = None,
            rounds: Optional[int] = None):
        """Drive the clients for ``seconds`` (a measured window) or for
        ``rounds`` requests each (warm-up).  Returns (every request sent,
        as ``Done``, the clock at the first send, the clock at the close).
        Replies to requests sent before the close are waited for, up to
        ``GRACE_S`` past it."""
        left = {id(c): rounds for c in self.clients}
        t_first = clock()
        t_close = t_first + seconds if seconds is not None else None
        pending = deque(self._send(c) for c in self.clients)
        done: List[Done] = []
        while pending:
            p = pending.popleft()
            limit = None if t_close is None else max(
                0.0, t_close + GRACE_S - clock())
            res, err = None, None
            with self.span("sb.result_wait"):
                try:
                    res = p.ticket.result(timeout=limit)
                except TimeoutError:
                    err = f"no answer {GRACE_S:.0f} s past the close"
                except Exception as exc:  # the ticket failed: report it
                    err = f"{type(exc).__name__}: {exc}"
            t1 = clock()
            if res is not None and not res.ok:
                err = res.error
            done.append(_done(p, t1, res, err))
            if t_close is not None:
                again = t1 < t_close
            else:
                left[id(p.client)] -= 1
                again = left[id(p.client)] > 0
            if again:
                pending.append(self._send(p.client))
        return done, t_first, t_close if t_close is not None else clock()


def _done(p: _Pending, t1: float, res, err: Optional[str]) -> Done:
    d = Done(design=p.client.design, pool_idx=p.pool_idx,
             t_submit=p.t_submit, t_done=t1, coef=None, error=err,
             queue_wait_s=p.ticket.queue_wait_s, fired_at=p.ticket.fired_at)
    if res is None:
        return d
    if err is None:
        # A column of the group's result: copy it so the group's arrays
        # (the residuals are obs long) are not kept alive.
        d.coef = np.array(res.coef, dtype=np.float32, copy=True)
    tel = res.telemetry
    if tel is not None:
        d.solve_s = tel.solve_s
        d.n_sweeps = tel.n_sweeps
        d.group_size = tel.group_size
    return d
