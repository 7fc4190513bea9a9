"""Multi-tensor fused optimizer engine — counterpart of ``paddle_tpu/optimizer/fused.py``.

Parameters are grouped into (dtype, device) buckets. Each bucket owns
one flat parameter buffer, one flat gradient buffer and flat optimizer
state, and a step is ONE update launch per bucket instead of one per
parameter.

In place, where the reference builds new arrays: when the engine is
built, every parameter's ``.data`` becomes a view into its bucket's flat
buffer, and its ``.grad`` a view into the flat gradient buffer. Each
parameter's offset is aligned to 16 bytes (the zero padding between
them stays zero through every update), so the kernel moves 16-byte
vectors. Autograd accumulates into an existing ``.grad`` in place
(``AccumulateGrad`` under ``backward()``), so after a backward the
gradients already lie in the flat buffer: no per-step concatenation and
no copies. ``zero_grad`` zeroes the flat gradient buffers with one fill
per bucket and gives every parameter its view back.

Which parameters take part, as in the reference
(``paddle_tpu/optimizer/fused.py:242-300``, ``:355-375``):

- the buckets hold the parameters that require a gradient; when the
  engine is built after gradients exist, those without one are left out;
- a bucketed parameter that got no gradient on a step is masked: its
  value and both moments stay bit for bit, and the buckets are not
  rebuilt. "No gradient" is ``.grad`` set to None, or no accumulation
  into it since the last ``zero_grad`` or step (a post-accumulate-grad
  hook per parameter keeps that presence set). The step stays one launch
  per bucket; with every parameter present it reads no span table, else
  the kernel takes the device table of the present spans, built once per
  presence pattern and cached;
- a parameter left out of the buckets that has a gradient at a step
  rebuilds them, its state starting at zero and the others' kept;
- a ``.grad`` replaced by a tensor of its own (not the bucket's view)
  makes :meth:`step` raise rather than update from a stale buffer.

A step's ``[lr, 1 - beta1^t, 1 - beta2^t]`` go to each bucket's device
``scalars`` through pinned staging (:meth:`stage_scalars`), queued on
the stream; the kernel reads them by pointer. A step captured into a
CUDA graph (``jit.TrainStep``) stages them before each replay, outside
the graph, and runs :meth:`step` with ``staged=True``.
"""
from __future__ import annotations

import torch

from ..core.staging import HostStaging
from ..kernels import check_not_capturing, keep_alive

# -- dispatch-count trace hook ---------------------------------------------
# Every optimizer-update launch records itself here; a step's delta is
# the fused path's headline count: O(#buckets), not O(#params).

_DISPATCH = {"count": 0}


def record_dispatch():
    _DISPATCH["count"] += 1


def dispatch_count() -> int:
    return _DISPATCH["count"]


#: bytes each parameter's offset in a bucket is aligned to
_ALIGN_BYTES = 16
#: span tables kept per bucket (presence patterns), oldest evicted first
_MAX_TABLES = 64


class _Bucket:
    __slots__ = ("params", "offsets", "flat_p", "flat_g", "state", "scalars",
                 "tables")


class FusedOptimizerEngine:
    """Flat (dtype, device) buckets over an optimizer's parameters."""

    def __init__(self, opt, params):
        self.opt = opt
        self._candidates = [p for p in params if p.requires_grad]
        #: ids of parameters accumulated into since the last zero_grad/step
        #: (one set for the engine's life: the hooks hold it, not the
        #: engine, since autograd keeps a hook where the cycle collector
        #: cannot see it, and a hook holding the engine kept the engine
        #: and its buckets alive after the optimizer was dropped)
        self._present: set = set()
        self._hooks: dict = {}
        self._staging = HostStaging()
        #: per bucket, the presence pattern the last step updated under
        self.last_presence = None
        have = [p for p in self._candidates if p.grad is not None]
        self._layout(have if have else self._candidates, {})
        # gradients that exist at the build count as this step's
        self._present.update(id(p) for p in have)

    # -- layout ----------------------------------------------------------

    def _layout(self, params, old_state):
        groups: dict = {}
        for p in params:
            groups.setdefault((p.dtype, p.device), []).append(p)
        self.buckets = [self._build(ps, old_state) for ps in groups.values()]
        self._bucketed = {id(p) for b in self.buckets for p in b.params}
        present = self._present
        for p in params:
            if id(p) not in self._hooks:
                self._hooks[id(p)] = p.register_post_accumulate_grad_hook(
                    lambda q: present.add(id(q)))

    def _build(self, params, old_state) -> _Bucket:
        b = _Bucket()
        b.params = list(params)
        p0 = b.params[0]
        align = max(1, _ALIGN_BYTES // p0.element_size())
        b.offsets = []
        total = 0
        for p in b.params:
            b.offsets.append(total)
            total += -(-p.numel() // align) * align
        b.flat_p = torch.zeros(total, dtype=p0.dtype, device=p0.device)
        b.flat_g = torch.zeros(total, dtype=p0.dtype, device=p0.device)
        with torch.no_grad():
            for p, off in zip(b.params, b.offsets):
                n = p.numel()
                b.flat_p[off:off + n].copy_(p.detach().reshape(-1))
                if p.grad is not None:
                    b.flat_g[off:off + n].copy_(p.grad.reshape(-1))
                p.data = b.flat_p[off:off + n].view(p.shape)
                p.grad = b.flat_g[off:off + n].view(p.shape)
        # the state after the parameters' own storage is freed: the peak
        # of the build stays at two copies of the bucket
        b.state = {name: torch.zeros(total, dtype=torch.float32,
                                     device=p0.device)
                   for name in self.opt._state_names()}
        for p, off in zip(b.params, b.offsets):
            for name, flat in b.state.items():
                if (id(p), name) in old_state:
                    flat[off:off + p.numel()].copy_(old_state[(id(p), name)])
        b.scalars = torch.zeros(3, dtype=torch.float32, device=p0.device)
        b.tables = {}
        return b

    def _rebuild(self, extra):
        """The buckets anew over the bucketed parameters and ``extra``,
        every bucketed parameter's state carried over."""
        old = {}
        for b in self.buckets:
            for p, off in zip(b.params, b.offsets):
                for name, flat in b.state.items():
                    old[(id(p), name)] = flat[off:off + p.numel()].clone()
        params = [p for p in self._candidates
                  if id(p) in self._bucketed or id(p) in extra]
        self._layout(params, old)

    # -- gradients -------------------------------------------------------

    def zero_grad(self):
        for b in self.buckets:
            b.flat_g.zero_()
        self.reset_host_state()

    def reset_host_state(self):
        """The host half of :meth:`zero_grad` and of a step's end: every
        parameter's ``.grad`` views its bucket again and the presence set
        is empty (a replayed step's graph ran neither)."""
        for b in self.buckets:
            for p, off in zip(b.params, b.offsets):
                if p.grad is None:
                    p.grad = b.flat_g[off:off + p.numel()].view(p.shape)
        self._present.clear()

    def check_aliasing(self):
        """Raise unless every parameter's ``.data``, and every ``.grad``
        that is not None, still view the bucket's flat buffers."""
        for b in self.buckets:
            for p, off in zip(b.params, b.offsets):
                base = off * b.flat_p.element_size()
                if p.data_ptr() != b.flat_p.data_ptr() + base or (
                        p.grad is not None and
                        p.grad.data_ptr() != b.flat_g.data_ptr() + base):
                    raise RuntimeError(
                        "fused optimizer: a parameter's data or grad no "
                        "longer views its flat bucket (was .grad replaced "
                        "after the optimizer was built?)")

    def _presence(self, b):
        """Per parameter of ``b``: whether it got a gradient this step."""
        return tuple(p.grad is not None and id(p) in self._present
                     for p in b.params)

    def span_table(self, b, present):
        """The device span table of ``b``'s present parameters, cached by
        the presence pattern (False when they hold no element)."""
        from ..kernels.fused_adamw import span_table
        t = b.tables.get(present)
        if t is None:
            check_not_capturing("a fused AdamW span table")
            spans = []
            for p, off, ok in zip(b.params, b.offsets, present):
                if not ok or p.numel() == 0:
                    continue
                if spans and spans[-1][0] + spans[-1][1] >= off:
                    # adjacent: merged over the zero padding between them
                    spans[-1] = (spans[-1][0], off + p.numel() -
                                 spans[-1][0])
                else:
                    spans.append((off, p.numel()))
            t = span_table(spans, b.flat_p.dtype, b.flat_p.device) \
                if spans else False
            if len(b.tables) >= _MAX_TABLES:
                b.tables.pop(next(iter(b.tables)))
            b.tables[present] = t
        return keep_alive(t)

    # -- the step --------------------------------------------------------

    def stage_scalars(self, lr, t):
        """Each bucket's device ``scalars`` <- the step's scalars
        (``opt._step_scalars``), through pinned staging."""
        vals = torch.tensor(self.opt._step_scalars(lr, t),
                            dtype=torch.float32).numpy()
        for b in self.buckets:
            self._staging.copy_(b.scalars, vals)

    def step(self, lr, t, staged=False):
        """One update launch per bucket with a present parameter;
        ``staged``: the scalars of step ``t`` are already in place."""
        extra = {id(p) for p in self._candidates
                 if id(p) not in self._bucketed and p.grad is not None}
        if extra:
            check_not_capturing("a rebuild of the fused optimizer's buckets")
            self._rebuild(extra)
            self._present |= extra
        self.check_aliasing()
        if not staged:
            self.stage_scalars(lr, t)
        self.last_presence = []
        for b in self.buckets:
            present = self._presence(b)
            self.last_presence.append(present)
            if not any(present):
                continue                      # the whole bucket untouched
            spans = None if all(present) else self.span_table(b, present)
            if spans is False:
                continue
            self.opt._fused_flat_update(b, lr, t, spans)
            record_dispatch()
        self.last_presence = tuple(self.last_presence)
        self._present.clear()

    def state_views(self):
        """``{(param, name): view}`` of the flat state, param-shaped."""
        out = {}
        for b in self.buckets:
            for p, off in zip(b.params, b.offsets):
                for name, flat in b.state.items():
                    out[(p, name)] = flat[off:off + p.numel()].view(p.shape)
        return out


__all__ = ["FusedOptimizerEngine", "dispatch_count", "record_dispatch"]
