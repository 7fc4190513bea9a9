"""The compiled execution path — counterpart of ``paddle_tpu.jit``.

The reference traces a function, or a whole training step, into one XLA
executable cached by input shapes. Here the counterpart of an executable
is a CUDA graph (``jit/_capture.py``): the same hand-written kernels, in
the same order, captured once per key and replayed with one launch.

- ``to_static(fn_or_layer)``: a :class:`StaticFunction` keyed as the
  reference keys it (each tensor's shape and dtype, the ``repr`` of each
  Python argument, the layer's ``training`` flag), run without
  gradients as the reference's compiled forward is. On CUDA a key's
  first call is an eager warm-up, its second captures, and later calls
  replay; on the CPU it calls the function. A signature whose capture
  fails (it needs tensor values on the host: ``.item()``, a
  data-dependent ``if``) warns once and runs eagerly from then on.
- ``TrainStep(model, loss_fn, optimizer)``: clear the gradients, run K
  micro-batch forwards and backwards, divide the gradient sums by K, one
  optimizer update — captured as one graph per key (batch shapes, K,
  the remat policy, which parameters require a gradient). The
  optimizer's step scalars are staged from the host before each replay
  (``optimizer/fused.py``); the step count advances on the host. A
  capture that fails raises.
- ``enable_to_static(False)`` switches capture off everywhere: every
  owner (``to_static``, ``TrainStep``, ``LLMEngine``) runs eagerly.

``accumulate_steps=K`` splits the batch into K equal micro-batches
along axis 0; autograd adds each micro-batch's gradients in place into
the optimizer's flat gradient buckets, the sum is divided by K, and one
optimizer step follows: the update of one step on the K× batch with a
mean loss, as the reference's scanned accumulator computes it. A batch
that does not split into K runs as one micro-batch (one warning), under
a key, and a graph, of its own. ``remat_policy`` pins the remat policy
for the step; None defers to ``FLAGS_remat_policy`` and the model's
``config.remat``.

Not ported, each raising ``NotImplementedError``: GSPMD ``sharding``
(ROADMAP queue A's distributed item, ``distributed/gspmd.py`` presets),
``capture_hlo`` (no XLA here), ``save``/``load`` (ROADMAP's long tail,
``jit/save_load.py``).
"""
from __future__ import annotations

import functools
import warnings
from contextlib import nullcontext

import torch
from torch.utils import _pytree as pytree

from ..core.flags import GLOBAL_FLAGS, define_flag
from ..nn.scan_stack import (REMAT_POLICIES, effective_remat_policy,
                             remat_policy_scope)
from ._capture import (CaptureError, GraphCache, capture_enabled,
                       set_capture_enabled)

if "v" not in GLOBAL_FLAGS:
    define_flag("v", int, 0, "verbosity of the port's diagnostics "
                "(jit.set_verbosity)")


def _first_device(tensors):
    for t in tensors:
        if t.device.type == "cuda":
            return t.device
    return torch.device("cpu")


class StaticFunction:
    """A function (or a Layer's forward) run through CUDA graphs, one per
    key (reference: ``paddle_tpu/jit/__init__.py:68``). ``_cache`` counts
    the calls of each key, as the reference's holds one executable per
    key; ``_graph_broken`` holds the keys that run eagerly."""

    def __init__(self, fn, layer=None):
        self._fn = fn
        self._layer = layer
        self._cache: dict = {}
        self._graphs = GraphCache(getattr(fn, "__name__", "fn"),
                                  strict=False)
        functools.update_wrapper(self, fn)

    @property
    def _graph_broken(self):
        return self._graphs.broken

    def _key(self, flat_args):
        sig = tuple(
            (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
            else ("py", repr(a)) for a in flat_args)
        training = self._layer.training if self._layer is not None else None
        return (sig, training)

    def __call__(self, *args, **kwargs):
        if getattr(self._fn, "_not_to_static", False) or \
                not capture_enabled():
            return self._fn(*args, **kwargs)
        leaves, spec = pytree.tree_flatten((args, kwargs))
        key = self._key(leaves)
        self._cache[key] = self._cache.get(key, 0) + 1
        pos = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        tensors = [leaves[i] for i in pos]
        state = list(self._layer.parameters()) if self._layer is not None \
            else []

        def run(*ts):
            vals = list(leaves)
            for i, t in zip(pos, ts):
                vals[i] = t
            a, kw = pytree.tree_unflatten(vals, spec)
            with torch.no_grad():
                return self._fn(*a, **kw)

        return self._graphs(key, run, tensors,
                            device=_first_device(tensors + state))

    @property
    def forward(self):
        return self


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, **kwargs):
    """``paddle.jit.to_static`` (reference: ``paddle_tpu/jit/__init__.py:368``):
    a function becomes a :class:`StaticFunction`; a Layer keeps its
    identity with its forward replaced by one."""

    def deco(fn):
        if isinstance(fn, torch.nn.Module):
            fn.forward = StaticFunction(fn.forward, fn)
            return fn
        return StaticFunction(fn, None)

    if function is None:
        return deco
    return deco(function)


def not_to_static(fn):
    """Mark ``fn`` to run eagerly even when wrapped by ``to_static``."""
    fn._not_to_static = True
    return fn


def enable_to_static(flag=True):
    """The global capture switch: with ``False`` every owner
    (``to_static``, ``TrainStep``, ``LLMEngine``) runs eagerly."""
    set_capture_enabled(flag)


def ignore_module(modules):
    """Accepted for parity: nothing here transcribes a module's code, so
    there is nothing to leave out."""


def set_verbosity(level=0, also_to_stdout=False):
    """Verbosity of the port's diagnostics (``FLAGS_v``)."""
    GLOBAL_FLAGS.set("v", int(level))


def set_code_level(level=100, also_to_stdout=False):
    """Accepted for parity: a CUDA graph has no transformed code to
    show."""


def save(layer, path, input_spec=None, **config):
    raise NotImplementedError("jit.save is not ported yet: ROADMAP's long "
                              "tail item 'jit/save_load.py' ports it")


def load(path, **config):
    raise NotImplementedError("jit.load is not ported yet: ROADMAP's long "
                              "tail item 'jit/save_load.py' ports it")


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)``
    where ``loss_fn(*batch)`` runs the model and returns a scalar loss.
    The step returns the loss without waiting for the device.
    ``last_compile_ms`` and ``compile_ms_total`` hold the capture time of
    the last captured key and of all of them."""

    def __init__(self, model, loss_fn, optimizer, accumulate_steps=1,
                 remat_policy=None, sharding=None, capture_hlo=False):
        self.accumulate_steps = int(accumulate_steps)
        if self.accumulate_steps < 1:
            raise ValueError("accumulate_steps must be >= 1")
        if remat_policy is not None and remat_policy not in REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be one of {REMAT_POLICIES} or None, "
                f"got {remat_policy!r}")
        if sharding is not None:
            raise NotImplementedError("TrainStep(sharding=...) comes with "
                                      "ROADMAP queue A's distributed item "
                                      "(distributed/gspmd.py presets)")
        if capture_hlo:
            raise NotImplementedError("TrainStep(capture_hlo=True) has no "
                                      "counterpart without XLA: the step is "
                                      "a CUDA graph, not an HLO module")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.remat_policy = remat_policy
        self._warned_ragged = False
        #: the step's graphs: keys, capture times, pool bytes, calls
        self.graphs = GraphCache("TrainStep", strict=True)
        #: per key, the presence pattern the warm-up's update ran under
        self._presence: dict = {}
        self.last_compile_ms = None
        self.compile_ms_total = 0.0

    def _micro_batches(self, batch):
        """K when every batch tensor splits into K equal micro-batches
        along axis 0; 1 (with a one-time warning) for a ragged batch."""
        K = self.accumulate_steps
        if K == 1:
            return 1
        if any(True for _ in self.model.buffers()):
            raise RuntimeError(
                "TrainStep(accumulate_steps>1) cannot accumulate over a "
                "model with registered buffers: per-micro-batch buffer "
                "mutations have no single committed value. Use "
                "accumulate_steps=1 (or an outer accumulation loop) for "
                "buffer-mutating models.")
        if any(not b.shape or b.shape[0] % K for b in batch):
            if not self._warned_ragged:
                self._warned_ragged = True
                warnings.warn(
                    f"TrainStep(accumulate_steps={K}): batch axis 0 "
                    f"{[tuple(b.shape) for b in batch]} is not divisible by "
                    f"{K}; running this batch without accumulation "
                    "(expected for a drop_last=False tail batch — if every "
                    "batch hits this, fix the batch size)", stacklevel=3)
            return 1
        return K

    def _key(self, batch, K):
        sig = tuple((tuple(b.shape), str(b.dtype))
                    if isinstance(b, torch.Tensor) else ("py", repr(b))
                    for b in batch)
        cfg_remat = getattr(getattr(self.model, "config", None), "remat",
                            False)
        remat = self.remat_policy or effective_remat_policy(cfg_remat)
        presence = tuple(p.requires_grad
                         for p in self.optimizer._parameter_list)
        return (sig, K, remat, presence)

    def __call__(self, *batch):
        K = self._micro_batches(batch)
        key = self._key(batch, K)
        opt = self.optimizer
        eng = opt._fused_engine
        t = opt._step_count + 1
        if eng is not None:
            # outside the graph: a replay reads them by pointer
            eng.stage_scalars(opt.get_lr(), t)
        pos = [i for i, b in enumerate(batch) if isinstance(b, torch.Tensor)]

        def step(*tensors):
            args = list(batch)
            for i, x in zip(pos, tensors):
                args[i] = x
            return self._step(args, K, t)

        params = list(opt._parameter_list)
        loss = self.graphs(key, step, [batch[i] for i in pos],
                           device=_first_device(params))
        opt._step_count = t
        mode = self.graphs.last_mode
        if mode == "replay":
            if eng is not None:
                eng.reset_host_state()
        elif eng is not None and mode in ("warmup", "capture"):
            seen = self._presence.setdefault(key, eng.last_presence)
            if seen != eng.last_presence:
                raise CaptureError(
                    "TrainStep: the parameters that got a gradient differ "
                    "between the warm-up and the capture of one key")
        if mode == "capture":
            self.last_compile_ms = self.graphs.last_capture_ms
            self.compile_ms_total = self.graphs.capture_ms_total
        return loss

    def _step(self, batch, K, t):
        """One step, as a graph captures it: clear the gradients, K
        forwards and backwards, the division by K, the update (its
        scalars already staged)."""
        policy = remat_policy_scope(self.remat_policy) \
            if self.remat_policy else nullcontext()
        opt = self.optimizer
        with policy:
            opt.clear_grad()
            if K == 1:
                loss = self.loss_fn(*batch)
                loss.backward()
                loss = loss.detach()
            else:
                loss = None
                for mb in zip(*(b.chunk(K) for b in batch)):
                    micro = self.loss_fn(*mb)
                    micro.backward()
                    micro = micro.detach().float()
                    loss = micro if loss is None else loss + micro
                self._divide_grads(K)
                loss = loss / K
            if opt._fused_engine is not None:
                with torch.no_grad():
                    opt._fused_engine.step(opt.get_lr(), t, staged=True)
        return loss

    def _divide_grads(self, K):
        """The accumulated gradient sums divided by K, in place: one op
        per flat bucket of the fused optimizer (the parameters' ``.grad``
        are views of them)."""
        eng = self.optimizer._fused_engine
        with torch.no_grad():
            for b in eng.buckets if eng is not None else ():
                b.flat_g.div_(K)


__all__ = ["CaptureError", "StaticFunction", "TrainStep", "enable_to_static",
           "ignore_module", "load", "not_to_static", "save",
           "set_code_level", "set_verbosity", "to_static"]
