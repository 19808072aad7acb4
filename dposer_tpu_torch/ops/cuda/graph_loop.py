"""A sampling loop captured once into a CUDA graph and replayed a call.

Port of the loop inside the TPU programs: ``dposer_tpu/ops/pallas/``
``fused_em.py``, ``fused_comp.py``, ``fused_ode.py`` and ``fused_lik.py`` each
run their whole fixed-length loop inside one ``pallas_call`` (a
``jax.lax.fori_loop`` around the step's body), so the host submits one
program a call. The port's loops launch each step's kernels (K1-K13) from
Python, six launches a step, each 14-65 us of Python and ``ctypes``. On the
card a ``GraphLoop`` captures that host loop once into a
``torch.cuda.CUDAGraph``, and every later call replays it: one host
submission a call, the same kernels.

A loop runs on static buffers, made once where the loop is built: its state
and scratch, and the inputs (``z``, the observation and mask, the probe
``epsilon``, injected noise, the seed tensor of in-kernel normals) that
each call copies in on the current stream. The body resets every state
buffer it starts from, so the code that runs on the buffers is the same
captured or not: on the CPU, and under ``loop="eager"``, each call runs it
directly. A call returns fresh clones of the body's outputs, so two calls
never alias.

Before the capture, at the first call, the body runs on a side stream with
a throwaway seed and ``warm_up=True``: the steps of the loop that launch
every kernel it launches (its first and last, or the stages of its first
step), which loads the libraries, sets the kernels' function attributes and
fills K1's tensor-map cache for the static buffers, at a few steps' cost
(it never draws from a caller's generator). The launch counters of ``fused_em.launch_counts`` and
``route_counts`` then count what the capture recorded, once a replay, and
not the warm-up or the capture itself, so a replayed call counts what the
same eager call does. A failed capture or replay raises; nothing falls back
to the eager loop.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from ...utils import profiling

THROWAWAY_SEED = 0x5EED  # the warm-up's seed: its draws are overwritten


def resolve_loop(loop: Optional[str], device: torch.device, plain: bool,
                 in_kernel_normals: bool = True) -> str:
    """The loop a sampler, solver or likelihood runs: ``"graph"`` or
    ``"eager"``. ``None`` picks the graph on the card for kernels that draw
    their normals in-kernel (or draw none), else the eager loop. ``"graph"``
    needs a CUDA device and the kernels themselves (``plain=False``)."""
    if loop is None:
        return "graph" if device.type == "cuda" and not plain and in_kernel_normals else "eager"
    if loop not in ("graph", "eager"):
        raise ValueError(f"loop must be 'graph' or 'eager', got {loop!r}")
    if loop == "graph" and (device.type != "cuda" or plain):
        raise ValueError("loop='graph' captures the CUDA kernels: it needs a CUDA device "
                         "and plain=False")
    return loop


def _counters():
    from .fused_em import _counted  # fused_em imports this module

    return _counted()


def _counts_now() -> Dict[str, tuple]:
    """Every kernel's launch count and route counts as they stand."""
    return {fn.__name__: (fn.launches, dict(getattr(fn, "routes", {}))) for fn in _counters()}


def _counts_delta(after: dict, before: dict) -> Dict[str, tuple]:
    return {name: (n - before[name][0], {r: c - before[name][1][r] for r, c in routes.items()})
            for name, (n, routes) in after.items()}


def _set_counts(counts: dict) -> None:
    for fn in _counters():
        fn.launches, routes = counts[fn.__name__]
        for r, c in routes.items():
            fn.routes[r] = c


def _add_counts(delta: dict) -> None:
    for fn in _counters():
        n, routes = delta[fn.__name__]
        fn.launches += n
        for r, c in routes.items():
            fn.routes[r] += c


def _fresh(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) else out.clone()


class GraphLoop:
    """``body`` on static buffers: run at every call (``graph=False``) or
    captured into a CUDA graph at the first call and replayed at every call.

    ``inputs`` are the static input buffers by name: a call's ``values``
    (tensors of the same shapes) are copied into them on the current
    stream. ``body(**host)`` reads them, resets the state it starts from and
    returns a static tensor or a tuple of them; ``host`` (the eager loop
    only) passes what cannot be captured, such as a generator that draws
    host normals step by step. ``body(warm_up=True)`` runs only the steps
    that launch each of the loop's kernels, for the warm-up. After the
    first replayed call, ``warmup_s``, ``capture_s`` and ``instantiate_s``
    hold the seconds of the warm-up, of the capture (the host loop issuing
    into the graph) and of ending the capture (the graph's instantiation),
    and ``launches`` the kernel launches of one replay. ``GraphLoop.captures``
    and ``GraphLoop.replays`` count the captures and the replays made in
    this process.

    A call is the span ``loop.replay`` (``loop.eager`` on the eager loop):
    the copy-in, the replay, the clone-out; with spans on, a pair of CUDA
    events around the replay alone gives its device time. The first call's
    warm-up, capture and instantiation are the set-up spans
    ``loop.warmup``, ``loop.capture`` and ``loop.instantiate``, whose
    seconds the three attributes hold."""

    captures = 0
    replays = 0

    def __init__(self, body: Callable, inputs: Dict[str, torch.Tensor], *, graph: bool):
        self.body, self.inputs, self.graph = body, inputs, graph
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._delta: Optional[dict] = None
        self.warmup_s = self.capture_s = self.instantiate_s = None

    @property
    def launches(self) -> Optional[Dict[str, int]]:
        return None if self._delta is None else {k: n for k, (n, _) in self._delta.items() if n}

    def __call__(self, values: Dict[str, object], **host):
        with profiling.span("loop.replay" if self.graph else "loop.eager"):
            for name, v in values.items():
                dst = self.inputs[name]
                if tuple(v.shape) != tuple(dst.shape):
                    raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                                     f"{tuple(dst.shape)}")
                dst.copy_(v)
            if not self.graph:
                return _fresh(self.body(**host))
            if host:
                raise ValueError(f"a replayed loop takes no host-side arguments: {sorted(host)}")
            if self._graph is None:
                self._capture()
            with profiling.device_events():
                self._graph.replay()
            GraphLoop.replays += 1
            _add_counts(self._delta)
            return _fresh(self._out)

    def _capture(self) -> None:
        start = _counts_now()
        try:
            self._warm_up_and_capture()
        finally:  # the warm-up and the capture are set-up, not calls
            _set_counts(start)

    def _warm_up_and_capture(self) -> None:
        dev = next(iter(self.inputs.values())).device
        seed = self.inputs.get("seed")
        with profiling.setup_span("loop.warmup") as warmup:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                kept = None if seed is None else seed.clone()
                if seed is not None:
                    seed.fill_(THROWAWAY_SEED)
                self.body(warm_up=True)
                if seed is not None:
                    seed.copy_(kept)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
        warm = _counts_now()
        graph = torch.cuda.CUDAGraph()
        with contextlib.ExitStack() as ending:
            with torch.cuda.graph(graph):
                with profiling.setup_span("loop.capture") as capture:
                    out = self.body()
                # ending the capture instantiates the graph
                instantiate = ending.enter_context(profiling.setup_span("loop.instantiate"))
        self.warmup_s, self.capture_s = warmup.seconds, capture.seconds
        self.instantiate_s = instantiate.seconds
        self._delta = _counts_delta(_counts_now(), warm)
        self._graph, self._out = graph, out
        GraphLoop.captures += 1
