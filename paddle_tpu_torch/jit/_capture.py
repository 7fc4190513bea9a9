"""CUDA-graph capture per shape key — the port's counterpart of the
reference's compiled executables (``jax.jit``, cached by shape).

A :class:`GraphCache` runs one callable per key:

- on the CPU, or with capture switched off (``jit.enable_to_static(False)``),
  it calls the function;
- the first call of a key on CUDA is the warm-up: an eager call, on the
  cache's side stream, whose effects count like any other call's. It
  makes every device table and scratch buffer the kernels' wrappers
  cache, so none is made during the capture;
- the second call captures the function with ``torch.cuda.graph`` on
  that side stream, into the cache's one graph pool, then replays the
  graph; later calls copy their tensors into the capture's static input
  buffers and replay. Outputs are cloned before they are returned, so an
  output kept from one call does not change at the next.

A replay runs no Python, so the kernels' wrappers count nothing: the
capture records each kernel's ``LAUNCHES`` delta (and takes it back, as
nothing ran) and every replay adds it. Objects the wrappers hand to
``kernels.keep_alive`` during the capture live as long as the graph.

A capture that fails raises :class:`CaptureError` under a strict owner
(``TrainStep``, ``LLMEngine``); otherwise (a user's ``to_static``
function) it warns once, and that key runs eagerly from then on.
"""
from __future__ import annotations

import time
import warnings

import torch
from torch.utils import _pytree as pytree

from .. import kernels

_SWITCH = {"enabled": True}


def capture_enabled() -> bool:
    """Whether owners capture (``jit.enable_to_static``)."""
    return _SWITCH["enabled"]


def set_capture_enabled(flag):
    _SWITCH["enabled"] = bool(flag)


class CaptureError(RuntimeError):
    """A strict owner's step could not be captured into a CUDA graph."""


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "out_spec", "launches",
                 "kept", "ms")


class GraphCache:
    """CUDA graphs of one owner, one per key, in one graph pool.

    ``cache(key, fn, tensors, device=...)`` returns ``fn(*tensors)``;
    ``fn`` returns a tensor or a pytree of tensors. With
    ``static_inputs=True`` the caller passes the same tensors for a key
    every call (already filled), and nothing is copied."""

    def __init__(self, name, strict=True):
        self.name = name
        self.strict = strict
        self._graphs: dict = {}
        self._warm: set = set()
        self.broken: set = set()
        self._pool = None
        self._stream = None
        #: every key seen, on any device and in either mode, in order
        self.keys: list = []
        #: counts: eager calls (capture off, CPU, broken keys),
        #: warm-ups, captures, replays
        self.calls = {"eager": 0, "warmup": 0, "capture": 0, "replay": 0}
        #: what the last call did: "eager", "warmup", "capture" (captured,
        #: then replayed) or "replay"
        self.last_mode = None
        self.last_capture_ms = None
        self.capture_ms_total = 0.0

    # -- accounting --------------------------------------------------------

    def capture_ms(self):
        """``{key: ms}`` of every captured key."""
        return {k: g.ms for k, g in self._graphs.items()}

    def pool_bytes(self):
        """Bytes of the segments the caching allocator holds in this
        cache's graph pool (None before a capture)."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # -- the call ----------------------------------------------------------

    def __call__(self, key, fn, tensors, *, device, static_inputs=False):
        if key not in self.keys:
            self.keys.append(key)
        device = torch.device(device)
        if device.type != "cuda" or not capture_enabled() or \
                key in self.broken:
            return self._run("eager", fn, tensors)
        g = self._graphs.get(key)
        if g is None and key not in self._warm:
            out = self._warmup(fn, tensors, device)
            self._warm.add(key)
            return out
        mode = "replay"
        if g is None:
            g = self._capture(key, fn, tensors, device, static_inputs)
            if g is None:                     # a graph break
                return self._run("eager", fn, tensors)
            mode = "capture"
        elif not static_inputs:
            for dst, src in zip(g.inputs, tensors):
                dst.copy_(src, non_blocking=True)
        elif any(a is not b for a, b in zip(g.inputs, tensors)):
            raise CaptureError(f"{self.name}: static inputs of key {key!r} "
                               f"changed")
        g.graph.replay()
        for k, n in g.launches.items():
            kernels.LAUNCHES[k] += n
        self.calls["replay"] += 1
        self.last_mode = mode
        leaves = [t.clone() for t in g.outputs]
        return pytree.tree_unflatten(leaves, g.out_spec)

    def _run(self, mode, fn, tensors):
        self.calls[mode] += 1
        self.last_mode = mode
        return fn(*tensors)

    def _side_stream(self, device):
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warmup(self, fn, tensors, device):
        main = torch.cuda.current_stream(device)
        side = self._side_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._run("warmup", fn, tensors)
        main.wait_stream(side)
        return out

    def _capture(self, key, fn, tensors, device, static_inputs):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = list(tensors) if static_inputs else \
            [t.clone() for t in tensors]
        g = _Graph()
        g.graph = torch.cuda.CUDAGraph()
        before = dict(kernels.LAUNCHES)
        kept: list = []
        kernels._KEEP.append(kept)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(g.graph, pool=self._pool,
                                  stream=self._side_stream(device)):
                out = fn(*inputs)
            g.outputs, g.out_spec = pytree.tree_flatten(out)
            if not all(isinstance(t, torch.Tensor) for t in g.outputs):
                raise TypeError("a captured function returns tensors only")
        except Exception as e:        # noqa: BLE001 - reported below
            self._graph_break(key, e, device)
            return None
        finally:
            kernels._KEEP.pop()
            delta = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
            kernels.LAUNCHES.update(before)   # the capture ran nothing
        g.ms = 1e3 * (time.perf_counter() - t0)
        g.inputs = inputs
        g.launches = {k: n for k, n in delta.items() if n}
        g.kept = kept
        self._graphs[key] = g
        self.calls["capture"] += 1
        self.last_capture_ms = g.ms
        self.capture_ms_total += g.ms
        return g

    def _graph_break(self, key, err, device):
        torch.cuda.synchronize(device)
        _end_generator_capture(device)
        if self.strict:
            raise CaptureError(f"{self.name}: the step of key {key!r} could "
                               f"not be captured into a CUDA graph: "
                               f"{type(err).__name__}: {err}") from err
        self.broken.add(key)
        warnings.warn(f"jit.to_static({self.name}): this input signature "
                      f"cannot be captured into a CUDA graph "
                      f"({type(err).__name__}: {err}); it runs eagerly "
                      f"from now on", stacklevel=4)


def _end_generator_capture(device):
    """A capture that fails before its end leaves the CUDA generators in
    capture mode (a capture ends their capture only when it ends well),
    and the next random draw outside a graph raises. A throwaway capture
    of one small op, begun and ended, ends it."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=torch.cuda.Stream(device)):
        torch.zeros(1, device=device)


__all__ = ["CaptureError", "GraphCache", "capture_enabled",
           "set_capture_enabled"]
