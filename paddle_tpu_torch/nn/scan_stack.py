"""Remat policy — counterpart of the policy part of ``paddle_tpu/nn/scan_stack.py``.

``FLAGS_remat_policy`` ∈ {none, dots_saveable, full} chooses how a
decoder stack trades recomputation for activation memory, resolved by
:func:`effective_remat_policy` with the reference's precedence: a
``TrainStep(remat_policy=...)`` override (:class:`remat_policy_scope`),
then the flag, then the model's ``config.remat``, which maps to
``full``. On the port's unrolled layer loop any policy but ``none``
recomputes each whole decoder layer in backward
(``distributed.fleet.recompute``), as the reference's unrolled path
does.

Not ported yet: :class:`LayerStack`, the scanned stack of
``FLAGS_scan_layers``, where ``dots_saveable`` saves the matrix
products' outputs and recomputes only the elementwise tail (ROADMAP item
'nn').
Setting that flag raises.
"""
from __future__ import annotations

from ..core.flags import GLOBAL_FLAGS, define_flag

REMAT_POLICIES = ("none", "dots_saveable", "full")


def _check_remat_policy(v):
    if v not in REMAT_POLICIES:
        raise ValueError(
            f"FLAGS_remat_policy must be one of {REMAT_POLICIES}, got {v!r}")


def _check_scan_layers(v):
    if v:
        raise NotImplementedError("FLAGS_scan_layers (nn.LayerStack) is not "
                                  "ported yet (ROADMAP item 'nn')")


define_flag("scan_layers", bool, False,
            "build decoder stacks as one scanned nn.LayerStack: not ported "
            "yet (ROADMAP item 'nn'); only False is accepted",
            on_set=_check_scan_layers)
define_flag("remat_policy", str, "none",
            "activation rematerialization of decoder stacks: none (save "
            "all), dots_saveable, full (recompute the whole layer in "
            "backward); on the unrolled layer loop any non-none policy "
            "recomputes each whole layer", on_set=_check_remat_policy)


# Scoped override used by jit.TrainStep(remat_policy=...) so a step can
# pin a policy without changing the global flag.
_POLICY_OVERRIDE: list = []


class remat_policy_scope:
    """Context manager overriding the effective remat policy."""

    def __init__(self, policy):
        _check_remat_policy(policy)
        self.policy = policy

    def __enter__(self):
        _POLICY_OVERRIDE.append(self.policy)
        return self

    def __exit__(self, *exc):
        _POLICY_OVERRIDE.pop()
        return False


def effective_remat_policy(config_remat: bool = False) -> str:
    """Resolve the policy: TrainStep override > FLAGS_remat_policy > the
    per-model ``config.remat`` (which maps to ``full``)."""
    if _POLICY_OVERRIDE:
        return _POLICY_OVERRIDE[-1]
    p = GLOBAL_FLAGS.get("remat_policy")
    if p == "none" and config_remat:
        return "full"
    return p


__all__ = ["REMAT_POLICIES", "effective_remat_policy", "remat_policy_scope"]
