"""LLMEngine — continuous-batching serving over the ragged attention kernel.

Counterpart of ``paddle_tpu/serving/engine.py``, default configuration:

    engine = LLMEngine(model, max_len=256, page_size=16)
    rid = engine.add_request([1, 2, 3], max_new_tokens=8)
    while engine.has_unfinished():
        for out in engine.step():       # incremental token streaming
            ...
    tokens = engine.outputs()[rid].token_ids

Every step is one ragged step of FIXED shapes — ``step_token_budget``
packed query tokens over ``max_num_seqs`` row slots with
``[max_num_seqs, max_len // page_size]`` block tables — whatever mix of
decode rows and prefill chunks it carries. Everything request-specific
is data.

On CUDA each step replays a CUDA graph (``jit/_capture.py``), the
counterpart of the reference's ``jax.jit`` of its ragged step and burst
(``paddle_tpu/serving/engine.py:1091-1092``). The ragged step's graph
runs from the packed int operands to the logits and the ``isfinite``
row guard and the sampled tokens, one graph per engine and whether a
row samples (an int8 pool: also one per append-plan ``bound``, the most
pages a row appends into); the host packs the operands and copies them
in one queued copy from pinned memory, and reads the tokens and the
guard back once. A burst's graph runs all its iterations, one graph per
burst length (and whether a row samples). The sampled rows' uniforms
are drawn ahead of the replay from their per-row generators into a
static buffer (``models/generation.draw_uniforms``), the draws
``sample_rows`` makes. ``jit.enable_to_static(False)`` runs the same
code eagerly; a capture that fails raises.

Each layer runs the fp layer body ``spec_decode._ragged_fp_layer``,
whose attention is ``kernels/paged_attention.ragged_paged_attention``:
the hand-written CUDA kernel on a CUDA device, its plain PyTorch
version on the CPU.

Low-bit serving: ``quantized_mode="weight_only_int8"`` (or ``"..._int4"``)
quantizes every attention and MLP projection per out channel
(``quantization/low_bit.py``); each runs the dequant-matmul kernel
(``kernels/int8_matmul.py``). ``kv_cache_dtype="int8"`` stores the pool
int8 with per-(kv head, page) scales: each layer runs
:func:`_ragged_int8_layer`, which quantize-appends the step's K/V
(:func:`_segmented_quant_append`) BEFORE the ragged attention reads the
pages, and int8 pools share only full pages between sequences.

Prefix caching: after a prompt is fully committed the engine registers
its page-aligned prefix chains; a later prompt starting with one is
admitted by FORKING the donor's pages (refcount + 1, no prefill
compute); the first divergent append into a shared partial page copies
it. Preemption recomputes: a victim's generated tokens are kept and its
prompt+tokens re-chunk through the same step, which computes each
token's K/V the same way however the work was chunked — so greedy
outputs do not depend on chunking, preemption or forks.

Sampling: greedy rows take the argmax. A sampled row's draw is a pure
function of (engine seed, request seed, generation position, tag), so a
request's sampled tokens do not depend on its batch (see
``models/generation.py``).

Burst decode: with ``burst_tokens=B > 1``, once every running row is a
caught-up decode row, ``step()`` plans a burst
(``Scheduler.prepare_burst``) and runs up to ``B`` decode iterations on
the device with no device read: each iteration is the decode megakernel
(``kernels/decode_megakernel.py``) per layer, or one launch for every
layer at ``megakernel_scope="model"``, each layer writing the token's
K/V into its pool slot inside the launch, then the final norm, the
logits, the sample and the EOS/length gate. The host reads the
device once, after the burst, and replays its tokens through the normal
commit path. Prefill chunks and mixed steps stay ragged steps.

Fused prefill: with ``prefill_megakernel="fused"`` every ragged step
(prefill chunks, mixed steps and per-token decode steps alike) runs the
prefill megakernel (``kernels/prefill_megakernel.py``): the projections
fused column-wise at init (q|k|v, gate|up), the rope tables, pool slots
and q block -> row map computed once per step, then one launch per layer
at either ``megakernel_scope``. int4 (or mixed) weights have no fused
geometry: the engine serves them unfused and reports
``prefill_megakernel="unfused"``, as the reference does.

Knobs of the reference that run other paths (speculative decoding,
adapters, tensor parallelism, a host KV tier, persistence, tracing; int4
weights in bursts) raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""
from __future__ import annotations

import itertools
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from ..core.flags import GLOBAL_FLAGS
from ..core.place import resolve_device
from ..core.staging import HostStaging
from ..jit._capture import GraphCache
from ..kernels.decode_megakernel import (_rope_tables, fused_decode_model,
                                         megakernel_mode)
from ..kernels.paged_attention import (ragged_block_row,
                                       ragged_paged_attention)
from ..kernels.prefill_megakernel import (fuse_layer_weights,
                                          fused_prefill_layer,
                                          fused_prefill_model,
                                          prefill_megakernel_mode,
                                          ragged_prologue)
from ..models.generation import (_logits, _rms_norm, _rope, _wmat,
                                 draw_uniforms, extract_params,
                                 resolve_megakernel_scope,
                                 resolve_prefill_megakernel, sample_rows_drawn)
from ..quantization.low_bit import params_weight_bytes, quantize_params
from .kv_cache import NULL_PAGE, PagedKVPool
from .metrics import ServingMetrics
from .scheduler import Scheduler, SchedulerConfig, Sequence, SequenceStatus
from .spec_decode import FINAL_TAG, _ragged_fp_layer, _ragged_packing
from .tracing import FlightRecorder


class RequestRejected(ValueError):
    """Structured admission rejection: the request could never be served
    (prompt + max_new_tokens over max_len or the pool's page limit). The
    engine records a finalized aborted ``RequestOutput`` under
    ``request_id`` before raising."""

    def __init__(self, request_id, reason, *, needed_pages=None,
                 limit=None, message=None):
        super().__init__(message or reason)
        self.request_id = request_id
        self.reason = reason
        self.needed_pages = needed_pages
        self.limit = limit


@dataclass
class Request:
    """What a client submits."""
    prompt_token_ids: list
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int | None = None
    top_p: float | None = None
    #: the request's own seed (None derives a stable one from its id)
    seed: int | None = None
    eos_token_id: int | None = None
    #: relative waiting SLO (s): shed if still waiting this long
    deadline_s: float | None = None
    #: relative e2e SLO (s): aborted if still unfinished this long
    abort_after_s: float | None = None
    request_id: str | None = None


@dataclass
class RequestOutput:
    """Live view of one request; ``token_ids`` grows as tokens stream."""
    request_id: str
    prompt_token_ids: list
    token_ids: list = field(default_factory=list)
    status: str = "waiting"
    finish_reason: str | None = None
    num_preemptions: int = 0

    @property
    def finished(self) -> bool:
        return self.status in ("finished", "shed", "cancelled", "aborted")


def _quantized_append(Pp, Ps, tok, page_ids, off, page_size, live):
    """Append one token per row into an int8 page with per-(head, page)
    scales, in place. The page's scale is the running amax/127 of
    everything in it: when the new token raises it, the page's values
    are requantized (dequant -> round at the new scale), so earlier
    tokens stay within one rounding step of their fp values. (The burst
    loop's append in the reference; the ragged step's segmented append
    below is this math exactly for single-token rows.)

    Pp: [Hkv, num_pages, ps, d] int8; Ps: [Hkv, num_pages] f32;
    tok: [Hkv, B, d] fp; page_ids/off/live: [B]. Dead rows (live=False)
    target the null page with an unchanged scale and write nothing.
    """
    old_s = Ps[:, page_ids]                              # [Hkv, B]
    amax = tok.abs().amax(-1)                            # [Hkv, B]
    new_s = torch.where(live[None, :],
                        torch.maximum(old_s, amax.clamp_min(1e-8) / 127.0),
                        old_s)
    ratio = torch.where(new_s > 0, old_s / new_s, torch.zeros_like(new_s))
    page_q = torch.round(Pp[:, page_ids].to(torch.float32)
                         * ratio[:, :, None, None]).clamp(-127, 127)
    tok_q = torch.round(tok / new_s[:, :, None].clamp_min(1e-30)) \
        .clamp(-127, 127)
    sel = (torch.arange(page_size, device=Pp.device)[None, None, :, None]
           == off[None, :, None, None]) & live[None, :, None, None]
    Pp[:, page_ids] = torch.where(sel, tok_q[:, :, None, :], page_q) \
        .to(torch.int8)
    Ps[:, page_ids] = new_s


def _append_plan(tbls, q_starts, q_lens, kv_lens, page_size, chunk_cap,
                 num_tokens):
    """Where a step's segmented int8 append writes, computed on the host
    from the step's plan (numpy, no device read). A row appends into at
    most ``bound`` consecutive pages (the reference's loop count: one for
    a decode-only step); each (row, page slot j < bound) pair is one
    entry. Returns int32 arrays ``page [N]`` (the pool page, the null
    page where the pair writes nothing), ``tok_idx [N, ps]`` (each page
    position's token in the packed chunk) and ``sel [N, ps]`` (1 where
    the position takes a new token), with ``N = rows x bound``."""
    ps = page_size
    R, pps = tbls.shape
    start = np.maximum(kv_lens - q_lens, 0)
    first = start // ps
    last = np.where(q_lens > 0, np.maximum(kv_lens - 1, 0) // ps, first - 1)
    bound = int(np.clip((last - first + 1).max(initial=0), 0,
                        -(-chunk_cap // ps) + 1))
    pidx = first[:, None] + np.arange(bound)[None, :]     # [R, bound]
    pg_lo = pidx * ps
    w_lo = np.maximum(start[:, None], pg_lo)              # write range
    w_hi = np.minimum(kv_lens[:, None], pg_lo + ps)       # cap the page
    live = (w_lo < w_hi) & (q_lens[:, None] > 0)
    page = np.where(live, tbls[np.arange(R)[:, None],
                               np.clip(pidx, 0, pps - 1)], NULL_PAGE)
    slot = pg_lo[..., None] + np.arange(ps)               # [R, bound, ps]
    tok_idx = np.clip(q_starts[:, None, None] + slot - start[:, None, None],
                      0, num_tokens - 1)
    sel = (slot >= w_lo[..., None]) & (slot < w_hi[..., None]) \
        & live[..., None]
    return (page.reshape(-1).astype(np.int32),
            tok_idx.reshape(-1, ps).astype(np.int32),
            sel.reshape(-1, ps).astype(np.int32))


def _segmented_quant_append(Pp, Ps, chunk, page, tok_idx, sel):
    """Segmented int8 chunk append, in place: ONE running-amax requant
    per touched (head, page). Per touched page the final scale is
    ``max(old_scale, amax(new tokens in the page) / 127)``; the page's
    existing content is requantized once at that scale and every new
    token is quantized directly at it (a single-token append is
    :func:`_quantized_append`'s math exactly).

    Pp: [Hkv, num_pages, ps, d] int8; Ps: [Hkv, num_pages] f32;
    chunk: [Hkv, T, d] fp new tokens packed row-wise (the ragged step's
    query packing); ``page`` [N] long, ``tok_idx`` [N, ps] long and
    ``sel`` [N, ps] bool: :func:`_append_plan` on the device. The
    reference loops over the page slots; their pages are distinct
    (copy-on-write gives rows disjoint write pages), so every slot is
    done at once. Entries that write nothing target the null page and
    write zeros there.
    """
    live = sel.any(-1)                                   # [N]
    new = chunk[:, tok_idx]                              # [Hkv, N, ps, d]
    amax = torch.where(sel[None, :, :, None], new.abs(), 0.0) \
        .amax(dim=(2, 3))
    old_s = Ps[:, page]
    new_s = torch.where(live[None, :],
                        torch.maximum(old_s, amax.clamp_min(1e-8) / 127.0),
                        old_s)
    ratio = torch.where(new_s > 0, old_s / new_s, 0.0)
    page_q = torch.round(Pp[:, page].to(torch.float32)
                         * ratio[:, :, None, None]).clamp_(-127, 127)
    tok_q = torch.round(new / new_s[:, :, None, None].clamp_min(1e-30)) \
        .clamp_(-127, 127)
    Pp[:, page] = torch.where(sel[None, :, :, None], tok_q, page_q) \
        .to(torch.int8)
    Ps[:, page] = new_s


def _chunk_append_fn(append):
    """An int8 pool's ``quant_append_fn`` for one ragged step: the
    segmented append of K, then of V, over the step's plan ``append``
    (:func:`_append_plan` on the device)."""
    def quant_append(Kp, Ks, Vp, Vs, kt, vt):
        _segmented_quant_append(Kp, Ks, kt, *append)
        _segmented_quant_append(Vp, Vs, vt, *append)
        return Kp, Ks, Vp, Vs
    return quant_append


def _ragged_int8_layer(lyr, h, Kp, Ks, Vp, Vs, positions, tbls, q_starts,
                       q_lens, kv_lens, cfg, q_block, append, block_row=None):
    """One decoder layer of the ragged forward over an int8 pool: qkv
    proj -> rope -> segmented quant append of K and V (pages and scales
    in place; ``append`` = the step's ``(page, tok_idx, sel)`` on the
    device) -> ragged attention over the int8 pages -> o proj -> mlp.
    The append lands BEFORE the attention reads the pages, so a token
    attends to its own K/V as cached (with its rounding). Returns the
    new ``h``."""
    H, Hkv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                 cfg.head_dim)
    T = h.shape[1]
    x = _rms_norm(h, lyr["ln1"], cfg.rms_norm_eps)
    q = _wmat(x, lyr["q"]).reshape(1, T, H, d)
    k = _wmat(x, lyr["k"]).reshape(1, T, Hkv, d)
    v = _wmat(x, lyr["v"]).reshape(1, T, Hkv, d)
    q = _rope(q, positions[None], cfg.rope_theta, d)
    k = _rope(k, positions[None], cfg.rope_theta, d)
    for P, S, new in ((Kp, Ks, k), (Vp, Vs, v)):
        _segmented_quant_append(P, S, new[0].transpose(0, 1), *append)
    o = ragged_paged_attention(q[0], Kp, Vp, tbls, q_starts, q_lens,
                               kv_lens, q_block=q_block, block_row=block_row,
                               k_scales=Ks, v_scales=Vs)
    h = h + _wmat(o.reshape(1, T, H * d), lyr["o"])
    x = _rms_norm(h, lyr["ln2"], cfg.rms_norm_eps)
    return h + _wmat(F.silu(_wmat(x, lyr["gate"])) * _wmat(x, lyr["up"]),
                     lyr["down"])


def _kv_dtype(kv_cache_dtype, default):
    """The pool dtype ``kv_cache_dtype`` names: ``"int8"``/``torch.int8``,
    another torch dtype or its name, or ``default`` for None."""
    if kv_cache_dtype is None:
        return default
    if isinstance(kv_cache_dtype, str):
        dtype = getattr(torch, kv_cache_dtype, None)
        if not isinstance(dtype, torch.dtype):
            raise ValueError(f"unknown kv_cache_dtype {kv_cache_dtype!r}")
        return dtype
    return kv_cache_dtype


def _not_ported(knob, item):
    raise NotImplementedError(
        f"LLMEngine({knob}) is not ported yet: ROADMAP item '{item}' "
        f"ports it")


class LLMEngine:
    """Continuous-batching serving engine over a paged KV pool.

    ``device=None`` serves on the current CUDA device (and raises without
    one); ``device="cpu"`` serves on the CPU through the kernels' plain
    versions. The model's weights are moved to that device.
    """

    def __init__(self, model, *, max_len=256, page_size=16, num_pages=None,
                 max_num_seqs=None, chunk_size=None, q_block=8,
                 step_token_budget=None, max_prefills_per_step=4,
                 prefix_caching=True, prefix_cache_size=4096,
                 pinned_prefix_pages=0, high_watermark=0.90,
                 low_watermark=0.50, seed=0, stream_cb=None,
                 now_fn=time.monotonic, device=None, burst_tokens=None,
                 draft_model=None, spec_tokens=None, quantized_mode=None,
                 kv_cache_dtype=None, mesh=None, tracer=None,
                 flight_recorder=None, flight_capacity=256,
                 gauge_stale_after_s=None, prefix_store=None,
                 host_kv_pages=0, fleet_prefix_cache=None, tenants=None,
                 adapter_slots=0, adapter_store=None,
                 megakernel_scope=None, prefill_megakernel=None):
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}")
        if burst_tokens is None:
            burst_tokens = int(GLOBAL_FLAGS.get("decode_burst_tokens"))
        if burst_tokens < 1:
            raise ValueError(f"burst_tokens must be >= 1, got "
                             f"{burst_tokens}")
        if burst_tokens > 1 and quantized_mode == "weight_only_int4":
            _not_ported("quantized_mode='weight_only_int4' with "
                        "burst_tokens>1", "int4 weights in decode bursts")
        # speculative decoding is active iff a draft model is given, as
        # in paddle_tpu/serving/engine.py:296-304: without one,
        # spec_tokens is validated and the engine serves with speculation
        # off
        if spec_tokens is None:
            spec_tokens = int(GLOBAL_FLAGS.get("spec_decode_tokens"))
        if spec_tokens < 0:
            raise ValueError(f"spec_tokens must be >= 0, got {spec_tokens}")
        if draft_model is not None:
            _not_ported("draft_model", "speculative decoding with a draft "
                        "model")
        if mesh is not None:
            _not_ported("mesh", "tensor-parallel serving")
        if host_kv_pages:
            _not_ported("host_kv_pages", "kv_tier host arena")
        if tracer is not None:
            _not_ported("tracer", "RequestTracer")
        if prefix_store is not None or fleet_prefix_cache is not None:
            _not_ported("prefix_store/fleet_prefix_cache",
                        "persistence and the fleet stack")
        if tenants is not None or adapter_slots or adapter_store is not None:
            _not_ported("tenants/adapters", "tenancy")
        prefill_megakernel = resolve_prefill_megakernel(prefill_megakernel)
        #: decode iterations per burst (1: the per-token path) and where
        #: the burst's layer loop lives ("layer" or "model")
        self.burst_tokens = int(burst_tokens)
        self.megakernel_scope = resolve_megakernel_scope(megakernel_scope)
        self.device = resolve_device(device)
        self.cfg = cfg = model.config
        self.params = _to_device(extract_params(model), self.device)
        # low-bit serving weights, quantized on the serving device; the
        # projections then run the dequant-matmul kernel
        self.params = quantize_params(self.params, quantized_mode)
        #: the ragged step's launch shape; "fused" runs every ragged step
        #: through the prefill megakernel over column-fused projections.
        #: int4 and mixed layouts have no fused geometry: they stay
        #: unfused, and the snapshot says so
        self.prefill_megakernel = prefill_megakernel
        self._fused_layers = None
        if self.prefill_megakernel == "fused":
            fused = [fuse_layer_weights(lyr) for lyr in self.params["layers"]]
            if any(f is None for f in fused):
                self.prefill_megakernel = "unfused"
            else:
                self._fused_layers = fused
        self.max_len = max_len
        self.page_size = page_size
        self.max_pages_per_seq = max_len // page_size
        if max_num_seqs is None:
            max_num_seqs = 8
        if chunk_size is None:
            chunk_size = min(64, max_len)
        self.chunk_size = chunk_size = min(chunk_size, max_len)
        if num_pages is None:
            # every row slot can hold a max_len sequence
            num_pages = max_num_seqs * self.max_pages_per_seq + 1
        self.pool = PagedKVPool(
            cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim,
            num_pages=num_pages, page_size=page_size,
            dtype=_kv_dtype(kv_cache_dtype, self.params["embed"].dtype),
            device=self.device,
            high_watermark=high_watermark, low_watermark=low_watermark,
            pinned_page_budget=pinned_prefix_pages)
        self.metrics = ServingMetrics(now_fn=now_fn,
                                      stale_after_s=gauge_stale_after_s)
        self.flight = flight_recorder if flight_recorder is not None \
            else FlightRecorder(flight_capacity)
        # a failing pool audit ships the flight recorder's context
        self.pool.flight_recorder = self.flight
        self.pool.flight_dump_counter = self.metrics.flight_dumps
        self.scheduler = Scheduler(
            self.pool,
            SchedulerConfig(max_num_seqs=max_num_seqs,
                            chunk_size=chunk_size, q_block=q_block,
                            step_token_budget=step_token_budget,
                            max_prefills_per_step=max_prefills_per_step,
                            now_fn=now_fn),
            self.max_pages_per_seq, metrics=self.metrics)
        self.max_num_seqs = self.scheduler.config.max_num_seqs
        self.q_block = self.scheduler.config.q_block
        self.step_token_budget = self.scheduler.config.step_token_budget
        self._now = now_fn
        self._stream_cb = stream_cb
        #: every sampled draw derives from this seed plus the request's
        #: own (seed, generation position) — never from shared state
        self.seed = int(seed)
        self._ids = itertools.count()
        self._seqs: dict[str, Sequence] = {}
        self._outputs: dict[str, RequestOutput] = {}
        self.prefix_caching = prefix_caching
        self.prefix_cache_size = prefix_cache_size
        #: token-chain -> (donor seq_id, chain length); re-validated on
        #: every hit (the donor may have left)
        self._prefix_cache: dict[tuple, tuple[str, int]] = {}
        #: page-aligned token-prefix -> (pinned chain id, length)
        self._pinned_index: dict[tuple, tuple[tuple, int]] = {}
        #: the ragged step's and the bursts' CUDA graphs; per key, the
        #: device buffers they read (operands; a burst's uniforms)
        self.graphs = GraphCache("LLMEngine", strict=True)
        self._static: dict = {}
        self._staging = HostStaging()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def add_request(self, prompt_token_ids, *, max_new_tokens=16,
                    temperature=0.0, top_k=None, top_p=None, seed=None,
                    eos_token_id=None, deadline_s=None, abort_after_s=None,
                    request_id=None):
        """Queue a request; returns its id. Accepts a :class:`Request`.

        An unserviceable request (prompt + max_new_tokens over max_len or
        over the pool's page limit) raises :class:`RequestRejected` AFTER
        recording a finalized aborted output under its id."""
        if isinstance(prompt_token_ids, Request):
            r = prompt_token_ids
            return self.add_request(
                r.prompt_token_ids, max_new_tokens=r.max_new_tokens,
                temperature=r.temperature, top_k=r.top_k, top_p=r.top_p,
                seed=r.seed, eos_token_id=r.eos_token_id,
                deadline_s=r.deadline_s, abort_after_s=r.abort_after_s,
                request_id=r.request_id)
        prompt = [int(t) for t in np.asarray(prompt_token_ids).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if top_k is not None and int(top_k) < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        rid = request_id or f"req-{next(self._ids)}"
        if rid in self._seqs or rid in self._outputs:
            raise KeyError(f"duplicate request_id {rid!r}")
        total = len(prompt) + max_new_tokens
        needed = self.pool.pages_for(total)
        limit = min(self.pool.capacity, self.max_pages_per_seq)
        if total > self.max_len or needed > limit:
            self._outputs[rid] = RequestOutput(
                rid, prompt, status="aborted",
                finish_reason="rejected_oversize")
            self.metrics.rejected_requests.inc()
            raise RequestRejected(
                rid, "rejected_oversize", needed_pages=needed, limit=limit,
                message=(
                    f"request {rid}: prompt {len(prompt)} + "
                    f"max_new_tokens {max_new_tokens} needs {needed} pages "
                    f"(limit {limit}) / {total} tokens (max_len "
                    f"{self.max_len}) — rejected at admission"))
        now = self._now()
        seq = Sequence(
            seq_id=rid, prompt_ids=prompt, max_new_tokens=max_new_tokens,
            arrival=now,
            deadline=None if deadline_s is None else now + deadline_s,
            abort_deadline=None if abort_after_s is None
            else now + abort_after_s,
            temperature=temperature,
            top_k=None if top_k is None else int(top_k),
            top_p=None if top_p is None else float(top_p),
            seed=((int(seed) & 0x7FFFFFFF) if seed is not None
                  else zlib.crc32(str(rid).encode("utf-8")) & 0x7FFFFFFF),
            eos_token_id=eos_token_id)
        self.scheduler.add(seq)
        self._seqs[rid] = seq
        self._outputs[rid] = RequestOutput(rid, prompt)
        self.metrics.requests_added.inc()
        return rid

    def cancel(self, request_id) -> bool:
        """Cancel: frees pages if running, keeps the tokens streamed so
        far. Returns False if already done."""
        seq = self.scheduler.remove(request_id)
        if seq is None:
            return False
        self._finalize(seq, "cancelled")
        self.metrics.cancelled_requests.inc()
        return True

    def has_unfinished(self) -> bool:
        return self.scheduler.has_unfinished()

    def outputs(self) -> dict:
        return dict(self._outputs)

    def release(self, request_id) -> RequestOutput:
        """Drop a RESOLVED request's retained state (the client has read
        its output); the engine keeps finished outputs until then."""
        out = self._outputs.get(request_id)
        if out is None:
            raise KeyError(f"unknown request {request_id!r}")
        if not out.finished:
            raise ValueError(
                f"request {request_id!r} is still {out.status}; "
                f"cancel() it before release()")
        del self._outputs[request_id]
        self._seqs.pop(request_id, None)
        return out

    def flight_dump(self, reason, **detail) -> dict:
        """Snapshot the flight recorder as a post-mortem."""
        self.metrics.flight_dumps.inc()
        return self.flight.dump(reason, t=self._now(), **detail)

    def metrics_snapshot(self) -> dict:
        """The metrics' snapshot plus the engine's configuration, under
        the reference's keys; ``device`` names where the engine runs."""
        snap = self.metrics.snapshot()
        snap["burst_tokens"] = self.burst_tokens
        snap["megakernel_scope"] = self.megakernel_scope
        snap["megakernel_mode"] = megakernel_mode(
            self.params["layers"][0], self.device) \
            if self.burst_tokens > 1 else None
        snap["prefill_megakernel"] = self.prefill_megakernel
        snap["prefill_megakernel_mode"] = prefill_megakernel_mode(
            self._fused_layers[0], self.device) \
            if self._fused_layers is not None else None
        snap["kv_hbm_pages"] = self.pool.capacity
        snap["kv_hbm_bytes"] = self.pool.pool_bytes
        # the low-bit path's byte accounting (the reference's bench probe
        # reads these off params_weight_bytes and the pool)
        snap["weight_bytes"] = params_weight_bytes(self.params)
        snap["kv_bytes_per_token"] = self.pool.kv_bytes_per_token
        tok = snap["tokens_generated"]
        snap["host_dispatches_per_token"] = \
            snap["host_dispatches"] / tok if tok else None
        snap["device"] = str(self.device)
        return snap

    def step(self):
        """One scheduler round: shed -> admit (prefix-fork) -> one device
        launch covering every running row: a burst of up to
        ``burst_tokens`` tokens per row when every row is a caught-up
        decode row and ``burst_tokens > 1``, else one ragged step.
        Returns the RequestOutputs touched this step (admitted, token
        streamed, finished, shed or preempted)."""
        touched = {}
        for seq in self.scheduler.shed_expired():
            self._finalize(seq, "shed")
            touched[seq.seq_id] = self._outputs[seq.seq_id]
        for seq in self.scheduler.abort_expired():
            self.metrics.deadline_aborts.inc()
            self._finalize(seq, "shed", reason="deadline_exceeded")
            touched[seq.seq_id] = self._outputs[seq.seq_id]
        hook = self._prefix_probe if self.prefix_caching else None
        for seq in self.scheduler.admit(prefix_hook=hook):
            touched[seq.seq_id] = self._sync_output(seq)
        plan = bplan = None
        preempted = []
        if self.burst_tokens > 1:
            bplan = self.scheduler.prepare_burst(self.burst_tokens)
            preempted += self.scheduler.last_preempted
        if bplan is None:
            plan = self.scheduler.prepare_step()
            preempted += self.scheduler.last_preempted
        for t in preempted:
            self._sync_output(t)           # surface fresh preemptions once
            touched[t.seq_id] = self._outputs[t.seq_id]
            self.flight.record("preempt", self._now(), request=t.seq_id)
        if bplan is not None:
            if bplan.cow_copies:
                self.metrics.cow_copies.inc(bplan.cow_copies)
            self._launch_burst(bplan, touched)
            self.metrics.decode_steps.inc()
            # pad fraction is a ragged-packing quantity
            self.metrics.ragged_pad_fraction.set(0.0)
        elif plan is not None:
            if plan.cow_copies:
                self.metrics.cow_copies.inc(plan.cow_copies)
            sampled, finite = self._launch(plan)
            step_prefill_rows = 0
            for i, (seq, _q_start, q_len) in enumerate(plan.rows):
                if not finite[i]:
                    # NaN/Inf logits: abort before any commit or prefix
                    # registration could spread the poisoned state
                    self._abort_nonfinite(seq)
                    touched[seq.seq_id] = self._outputs[seq.seq_id]
                    continue
                before = seq.cached_len
                seq.cached_len += q_len
                if q_len > 1 or before < len(seq.prompt_ids):
                    self.metrics.prefill_chunks.inc()
                    step_prefill_rows += 1
                if self.prefix_caching and \
                        before < len(seq.prompt_ids) <= seq.cached_len:
                    self._register_prefix(seq)
                if seq.cached_len == seq.total_len:
                    # caught up: the sampled token is the next generated
                    # one (mid-prompt chunks discard theirs)
                    self._commit_token(seq, int(sampled[i]))
                touched[seq.seq_id] = self._outputs[seq.seq_id]
            self.metrics.decode_steps.inc()
            if step_prefill_rows:
                self.metrics.prefill_launches.inc()
            self.metrics.ragged_pad_fraction.set(plan.pad_fraction)
        self.metrics.record_step(self.scheduler, self.pool)
        f = {"running": len(self.scheduler.running),
             "waiting": len(self.scheduler.waiting),
             "used_pages": self.pool.used_pages,
             "tokens": self.metrics.tokens_generated.value}
        self.flight.record("step", self._now(), **f)
        return list(touched.values())

    def run(self, max_steps=None):
        """Drive step() until every request resolves; returns outputs."""
        steps = 0
        while self.has_unfinished():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps")
        return self.outputs()

    # ------------------------------------------------------------------
    # prefix cache
    # ------------------------------------------------------------------
    def _register_prefix(self, seq: Sequence):
        """Index the prompt as a fork donor: one entry per page-aligned
        prefix plus the full prompt (an identical prompt shares even the
        partial tail page). LRU-bounded by ``prefix_cache_size``. With a
        pinned-page budget, the prompt's FULL pages are also pinned so
        the chain outlives its last sharer."""
        P = seq.prompt_ids
        ps = self.page_size
        for j in list(range(ps, len(P) + 1, ps)) + [len(P)]:
            key = tuple(P[:j])
            self._prefix_cache.pop(key, None)      # refresh LRU position
            self._prefix_cache[key] = (seq.seq_id, j)
        while len(self._prefix_cache) > self.prefix_cache_size:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))
        full = (len(P) // ps) * ps
        if full >= ps and self.pool.pinned_page_budget > 0:
            chain = tuple(P[:full])
            if self.pool.pin(chain, seq.seq_id, full):
                for j in range(ps, full + 1, ps):
                    key = tuple(P[:j])
                    self._pinned_index.pop(key, None)
                    self._pinned_index[key] = (chain, j)
                while len(self._pinned_index) > self.prefix_cache_size:
                    self._pinned_index.pop(next(iter(self._pinned_index)))

    def _prefix_probe(self, seq: Sequence) -> int:
        """Admission hook: fork the longest registered chain matching the
        prompt. Returns the shared token count, 0 on a miss. The last
        prompt token is never shared — its logits give the first
        generated token."""
        P = seq.prompt_ids
        ps = self.page_size
        cands = sorted({len(P)} | set(range(ps, len(P) + 1, ps)),
                       reverse=True)
        for j in cands:
            ent = self._prefix_cache.get(tuple(P[:j]))
            if ent is None:
                continue
            donor, length = ent
            if donor == seq.seq_id or donor not in self.pool:
                continue
            if self.pool.seq_len(donor) < length:
                continue
            # a reused request id may name a different prompt's pages:
            # re-validate against the donor's actual tokens
            donor_seq = self._seqs.get(donor)
            if donor_seq is None or donor_seq.prompt_ids[:j] != P[:j]:
                continue
            shared = min(j, len(P) - 1)
            if self.pool.quantized:
                # int8 pages requantize in place on append: only FULL
                # (append-free) pages are safe to share
                shared = (shared // ps) * ps
            if shared < 1:
                continue
            self.pool.fork(seq.seq_id, donor, num_tokens=shared)
            self.metrics.prefix_cache_hits.inc()
            return shared
        # no live donor: a pinned chain may still hold the prefix
        for j in cands:
            ent = self._pinned_index.get(tuple(P[:j]))
            if ent is None:
                continue
            chain, _length = ent
            if not self.pool.is_pinned(chain):
                self._pinned_index.pop(tuple(P[:j]), None)   # evicted
                continue
            shared = min(j, len(P) - 1)
            if self.pool.quantized:
                shared = (shared // ps) * ps
            if shared < 1:
                continue
            self.pool.fork_pinned(seq.seq_id, chain, shared)
            self.metrics.prefix_cache_hits.inc()
            self.metrics.pinned_prefix_hits.inc()
            return shared
        self.metrics.prefix_cache_misses.inc()
        return 0

    # ------------------------------------------------------------------
    # the ragged step
    # ------------------------------------------------------------------
    def _launch(self, plan):
        """Pack the plan into fixed-shape operands, run the ragged step
        and sample. Returns host arrays ``(tokens [R], finite [R])``; a
        row with ``finite[i] == False`` produced NaN/Inf logits."""
        T, R, PPS = plan.token_budget, plan.num_slots, self.max_pages_per_seq
        self.metrics.host_dispatches.inc()
        tokens = np.zeros((T,), np.int32)
        positions = np.zeros((T,), np.int32)
        tbls = np.full((R, PPS), NULL_PAGE, np.int32)
        q_starts = np.full((R,), T, np.int32)   # pad rows: start past T
        q_lens = np.zeros((R,), np.int32)
        kv_lens = np.zeros((R,), np.int32)
        sample_idx = np.zeros((R,), np.int32)
        temps = np.zeros((R,), np.float32)
        top_ks = np.zeros((R,), np.int32)
        top_ps = np.ones((R,), np.float32)
        seeds = [0] * R
        sample_pos = [0] * R
        for i, (seq, q_start, q_len) in enumerate(plan.rows):
            lo = seq.cached_len
            tokens[q_start:q_start + q_len] = seq.all_ids[lo:lo + q_len]
            positions[q_start:q_start + q_len] = np.arange(lo, lo + q_len)
            tbls[i] = self.pool.padded_block_table(seq.seq_id, PPS)
            q_starts[i] = q_start
            q_lens[i] = q_len
            kv_lens[i] = lo + q_len
            sample_idx[i] = q_start + q_len - 1
            temps[i] = seq.temperature
            top_ks[i] = seq.top_k or 0
            top_ps[i] = 1.0 if seq.top_p is None else seq.top_p
            seeds[i] = seq.seed
            sample_pos[i] = len(seq.tokens)
        # where an int8 pool's append writes: planned on the host, so the
        # step reads nothing back from the device; its size (rows x
        # bound) keys the step's graph
        plan = _append_plan(tbls, q_starts, q_lens, kv_lens, self.page_size,
                            self.chunk_size, T) \
            if self.pool.quantized else ()
        bound = plan[0].size // R if plan else 0
        hot = np.flatnonzero(temps > 0).tolist()
        ints = np.concatenate(
            [tokens, positions, tbls.reshape(-1), q_starts, q_lens, kv_lens,
             sample_idx, top_ks] + [a.reshape(-1) for a in plan]
            + [np.concatenate([temps, top_ps]).view(np.int32)])
        key = ("ragged", bound, bool(hot))
        # one queued host->device copy: the ints and the knobs' f32 bits
        buf = self._operands(key, ints.size)
        self._staging.copy_(buf, ints)
        inputs = [buf]
        if hot:
            # the sampled rows' uniforms, drawn ahead of the graph from
            # the generators the per-token sample seeds
            u = self._operands(key, R * self.cfg.vocab_size, torch.float32,
                               (R, self.cfg.vocab_size))
            draw_uniforms(u, self.seed, seeds, sample_pos, FINAL_TAG, hot)
            inputs.append(u)
        sizes = [T, T, R * PPS, R, R, R, R, R] + [a.size for a in plan] \
            + [2 * R]
        shapes = [a.shape for a in plan]

        def step(ints, uniforms=None):
            (tokens_t, positions_t, tbls_t, q_starts_t, q_lens_t, kv_lens_t,
             sample_idx_t, top_ks_t, *plan_t, knobs_t) = torch.split(ints,
                                                                     sizes)
            append = None
            if plan_t:
                page_t, tok_t, sel_t = plan_t
                append = (page_t.long(), tok_t.view(shapes[1]).long(),
                          sel_t.view(shapes[2]).bool())
            temps_t, top_ps_t = knobs_t.view(torch.float32).view(2, R)
            with torch.inference_mode():
                logits = self._ragged_forward(
                    tokens_t, positions_t, tbls_t.view(R, PPS), q_starts_t,
                    q_lens_t, kv_lens_t, sample_idx_t, append)
                finite = torch.isfinite(logits).all(-1) | (q_lens_t <= 0)
                out = logits.argmax(-1) if uniforms is None else \
                    sample_rows_drawn(logits, temps_t, top_ks_t, top_ps_t,
                                      uniforms)
                return logits, torch.cat([out, finite.long()])

        _, res = self.graphs(key, step, inputs, device=self.device,
                             static_inputs=True)
        res = res.cpu().numpy()
        return res[:R], res[R:].astype(bool)

    def _operands(self, key, n, dtype=torch.int32, shape=None):
        """The device buffer of ``n`` elements the graph of ``key`` reads
        (one per key and ``shape``, made at its first step)."""
        k = (key, n, dtype, shape)
        buf = self._static.get(k)
        if buf is None:
            buf = self._static[k] = torch.zeros(
                shape or (n,), dtype=dtype, device=self.device)
        return buf

    def _ragged_forward(self, tokens, positions, tbls, q_starts, q_lens,
                        kv_lens, sample_idx, append):
        """The model over one packed step; appends every live token's K/V
        to the pool in place and returns the logits at each row's last
        token, ``[R, vocab]``. ``append``: an int8 pool's append plan
        (:func:`_append_plan` on the device), else None."""
        cfg, p = self.cfg, self.params
        T, qb = tokens.shape[0], self.q_block
        h = p["embed"][tokens][None]                       # [1, T, hidden]
        if self._fused_layers is not None:
            h = self._fused_forward(h, positions, tbls, q_starts, q_lens,
                                    kv_lens, append)
            return _logits(p, _rms_norm(h, p["norm"], cfg.rms_norm_eps)
                           [0, sample_idx], cfg)
        # the q block -> row map, derived once per step for every layer
        block_row = ragged_block_row(q_starts, T // qb, qb)
        if self.pool.quantized:
            for lyr, (Kp, Vp), (Ks, Vs) in zip(p["layers"], self.pool.kv,
                                               self.pool.kv_scales):
                h = _ragged_int8_layer(lyr, h, Kp, Ks, Vp, Vs, positions,
                                       tbls, q_starts, q_lens, kv_lens, cfg,
                                       qb, append, block_row=block_row)
        else:
            tok_row, live = _ragged_packing(q_starts, q_lens, T)
            for lyr, (Kp, Vp) in zip(p["layers"], self.pool.kv):
                h = _ragged_fp_layer(lyr, h, Kp, Vp, positions, tbls,
                                     tok_row, live, q_starts, q_lens,
                                     kv_lens, cfg, self.page_size,
                                     self.max_pages_per_seq, qb,
                                     block_row=block_row)
        h = _rms_norm(h, p["norm"], cfg.rms_norm_eps)
        return _logits(p, h[0, sample_idx], cfg)

    def _fused_forward(self, h, positions, tbls, q_starts, q_lens, kv_lens,
                       append):
        """The decoder layers of one ragged step through the prefill
        megakernel: the step's prologue (rope tables, pool slots, q block
        -> row map) once, then the fused layer per layer (model scope:
        :func:`fused_prefill_model`, the same launches). An int8 pool
        appends through the host-planned segmented append first."""
        cfg, pool = self.cfg, self.pool
        pre = ragged_prologue(positions, tbls, q_starts, q_lens,
                              theta=cfg.rope_theta, head_dim=cfg.head_dim,
                              page_size=self.page_size,
                              max_pages=self.max_pages_per_seq,
                              q_block=self.q_block)
        kw = dict(eps=cfg.rms_norm_eps, num_heads=cfg.num_attention_heads,
                  q_block=self.q_block)
        if pool.quantized:
            kw["quant_append_fn"] = _chunk_append_fn(append)
        meta = (tbls, pre, q_starts, q_lens, kv_lens)
        if self.megakernel_scope == "model":
            scales = {}
            if pool.quantized:
                scales = dict(k_scales=[a for a, _ in pool.kv_scales],
                              v_scales=[b for _, b in pool.kv_scales])
            return fused_prefill_model(
                self._fused_layers, h, [K for K, _ in pool.kv],
                [V for _, V in pool.kv], *meta, **scales, **kw)[0]
        for i, (lyr, (Kp, Vp)) in enumerate(zip(self._fused_layers, pool.kv)):
            Ks, Vs = pool.kv_scales[i] if pool.quantized else (None, None)
            h = fused_prefill_layer(lyr, h, Kp, Vp, *meta, k_scales=Ks,
                                    v_scales=Vs, **kw)[0]
        return h

    # ------------------------------------------------------------------
    # the burst
    # ------------------------------------------------------------------
    def _launch_burst(self, bplan, touched):
        """Pack the burst's fixed-shape operands (one host-to-device
        copy), run up to ``burst_len`` decode iterations on the device,
        read the result back once, and replay each row's tokens through
        the normal commit path. A row whose logits went non-finite at any
        iteration commits nothing and is aborted; every row's committed
        pool length shrinks back to what the burst appended."""
        R, PPS = self.max_num_seqs, self.max_pages_per_seq
        B = bplan.burst_len
        ints = np.zeros((6, R), np.int32)       # tokens, kv_lens, live,
        ints[5] = -1                            # caps, top_ks, eos ids
        tbls = np.full((R, PPS), NULL_PAGE, np.int32)
        floats = np.zeros((2, R), np.float32)   # temps, top_ps
        floats[1] = 1.0
        seeds, gpos = [0] * R, [0] * R
        for i, (seq, cap) in enumerate(bplan.rows):
            ints[:, i] = (seq.all_ids[-1], seq.cached_len, 1, cap,
                          seq.top_k or 0,
                          -1 if seq.eos_token_id is None
                          else seq.eos_token_id)
            tbls[i] = self.pool.padded_block_table(seq.seq_id, PPS)
            floats[:, i] = (seq.temperature,
                            1.0 if seq.top_p is None else seq.top_p)
            seeds[i] = seq.seed
            gpos[i] = len(seq.tokens)
        hot = [i for i, (seq, _) in enumerate(bplan.rows)
               if seq.temperature > 0]
        self.metrics.host_dispatches.inc()
        self.metrics.burst_launches.inc()
        # one queued host->device copy: ints, tables, the knobs' f32 bits
        packed = np.concatenate([ints.reshape(-1), tbls.reshape(-1),
                                 floats.reshape(-1).view(np.int32)])
        key = ("burst", B, bool(hot))
        buf = self._operands(key, packed.size)
        self._staging.copy_(buf, packed)
        inputs = [buf]
        if hot:
            # each sampled row's uniforms of every iteration, drawn
            # ahead of the graph from the per-token path's generators
            V = self.cfg.vocab_size
            u = self._operands(key, B * R * V, torch.float32, (B, R, V))
            for i in range(B):
                draw_uniforms(u[i], self.seed, seeds,
                              [g + i for g in gpos], FINAL_TAG, hot)
            inputs.append(u)

        def burst(buf, uniforms=None):
            ints_t = buf[:6 * R].view(6, R)
            tbls_t = buf[6 * R:6 * R + R * PPS].view(R, PPS)
            knobs = buf[6 * R + R * PPS:].view(torch.float32).view(2, R)
            tokens, kv_lens, live, caps, top_ks, eos_ids = ints_t
            with torch.inference_mode():
                out, gen, ok = self._burst(
                    tokens, kv_lens, tbls_t, live.bool(), caps, knobs[0],
                    top_ks, knobs[1], eos_ids, uniforms, B)
                return torch.cat([out.reshape(-1), gen.long(), ok.long()])

        res = self.graphs(key, burst, inputs, device=self.device,
                          static_inputs=True).cpu().numpy()
        out = res[:R * B].reshape(R, B)
        gen, ok = res[R * B:R * B + R], res[R * B + R:]
        for i, (seq, _cap) in enumerate(bplan.rows):
            if not ok[i]:
                self.pool.set_seq_len(seq.seq_id, seq.cached_len)
                self._abort_nonfinite(seq)
                touched[seq.seq_id] = self._outputs[seq.seq_id]
                continue
            g = int(gen[i])
            seq.cached_len += g
            # prepare_burst committed cached + cap up front; a row that
            # finished early appended fewer
            self.pool.set_seq_len(seq.seq_id, seq.cached_len)
            for j in range(g):
                self._commit_token(seq, int(out[i, j]))
            touched[seq.seq_id] = self._outputs[seq.seq_id]

    def _burst(self, tokens, kv_lens, tbls, live, caps, temps, top_ks,
               top_ps, eos_ids, uniforms, n_steps):
        """``n_steps`` decode iterations over every row slot, on the
        device, with no device read and no host value: per iteration the
        decode megakernel for every layer (one launch at model scope)
        with the KV append, the final norm, the logits, the sample and
        the EOS/length gate. Rows carry ``live``, ``gen``, ``out`` and
        ``ok`` on the device; a dead row appends to the null page and
        keeps its ``kv_len``. ``uniforms [n_steps, R, V]``: the sampled
        rows' uniforms of each iteration, drawn at the row's generation
        position ``gpos[row] + i``, so its draws are those of the
        per-token path (None: every row is greedy). Returns
        ``(out [R, n_steps], gen [R], ok [R])``."""
        cfg, p, pool = self.cfg, self.params, self.pool
        R, ps, PPS = self.max_num_seqs, self.page_size, self.max_pages_per_seq
        H, d = cfg.num_attention_heads, cfg.head_dim
        eps, theta = cfg.rms_norm_eps, cfg.rope_theta
        quant = pool.quantized
        kw = dict(eps=eps, theta=theta, num_heads=H)
        rows = torch.arange(R, device=self.device)
        null = torch.full_like(kv_lens, NULL_PAGE)
        out = torch.zeros((R, n_steps), dtype=torch.int64, device=self.device)
        gen = torch.zeros_like(kv_lens)
        ok = torch.ones_like(live)
        Kps, Vps = [K for K, _ in pool.kv], [V for _, V in pool.kv]
        Kss = [a for a, _ in pool.kv_scales] if quant else None
        Vss = [b for _, b in pool.kv_scales] if quant else None
        # the layers of one launch: all of them (model scope) or one each
        L = len(Kps)
        groups = [slice(0, L)] if self.megakernel_scope == "model" else \
            [slice(li, li + 1) for li in range(L)]
        for i in range(n_steps):
            h = p["embed"][tokens]                          # [R, hidden]
            pos = kv_lens                                   # append slot
            page = torch.where(live, tbls[rows, (pos // ps).clamp(0, PPS - 1)],
                               null)
            off = pos % ps
            att_len = pos + 1           # attention covers the new token
            live_in = live
            # every layer of the iteration ropes at the same positions
            kw["rope_tables"] = _rope_tables(att_len, theta, d)
            for g in groups:
                # each layer writes its K/V into the slot (an int8 pool:
                # the running-amax append before the attention)
                h = fused_decode_model(
                    p["layers"][g], h, Kps[g], Vps[g], tbls, att_len,
                    self_kv=not quant, k_scales=Kss[g] if quant else None,
                    v_scales=Vss[g] if quant else None,
                    append_at=(page, off), **kw)[0]
            hn = _rms_norm(h[None], p["norm"], eps)[0]
            logits = _logits(p, hn, cfg)                     # [R, V]
            ok = ok & (torch.isfinite(logits).all(-1) | ~live_in)
            nxt = logits.argmax(-1) if uniforms is None else \
                sample_rows_drawn(logits, temps, top_ks, top_ps, uniforms[i])
            out[:, i] = torch.where(live, nxt, 0)
            gen = gen + live.to(gen.dtype)
            hit_eos = live & (eos_ids >= 0) & (nxt == eos_ids)
            live = live & ~hit_eos & (gen < caps)
            kv_lens = kv_lens + live_in.to(kv_lens.dtype)
            tokens = torch.where(live_in, nxt.to(tokens.dtype), tokens)
        return out, gen, ok

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _commit_token(self, seq: Sequence, tok: int):
        seq.tokens.append(int(tok))
        if seq.first_token_at is None:
            seq.first_token_at = self._now()
        self.metrics.tokens_generated.inc()
        out = self._sync_output(seq)
        if seq.eos_token_id is not None and tok == seq.eos_token_id:
            self._finalize(seq, "finished", reason="eos")
        elif len(seq.tokens) >= seq.max_new_tokens:
            self._finalize(seq, "finished", reason="length")
        elif self._stream_cb is not None:
            self._stream_cb(seq.seq_id, int(tok), False)
        return out

    def _abort_nonfinite(self, seq: Sequence):
        """Abort a row whose logits came back NaN/Inf (status aborted,
        reason ``nonfinite_logits``), with a flight-recorder dump."""
        self.metrics.nonfinite_rows.inc()
        self.flight.record("nonfinite", self._now(), request=seq.seq_id)
        self.flight_dump("nonfinite_logits", request=seq.seq_id)
        self._finalize(seq, "aborted", reason="nonfinite_logits")

    def _finalize(self, seq: Sequence, status: str, reason=None):
        self.scheduler.finish(seq, {
            "finished": SequenceStatus.FINISHED,
            "shed": SequenceStatus.SHED,
            "cancelled": SequenceStatus.CANCELLED,
            "aborted": SequenceStatus.ABORTED,
        }[status])
        out = self._sync_output(seq)
        out.finish_reason = reason or status
        if status in ("shed", "aborted"):
            self.flight.record(status, self._now(), request=seq.seq_id,
                               reason=out.finish_reason)
        if status == "finished":
            self.metrics.finished_requests.inc()
            self.metrics.record_request_end(
                arrival=seq.arrival, first_token_at=seq.first_token_at,
                finished_at=self._now(), n_tokens=len(seq.tokens))
        if self._stream_cb is not None:
            last = seq.tokens[-1] if seq.tokens else None
            self._stream_cb(seq.seq_id, last, True)
        return out

    def _sync_output(self, seq: Sequence) -> RequestOutput:
        out = self._outputs[seq.seq_id]
        out.token_ids = list(seq.tokens)
        out.status = seq.status.value
        out.num_preemptions = seq.num_preemptions
        return out


def _to_device(params, device):
    """The params dict with every tensor on ``device`` (no copy when a
    tensor is already there)."""
    out = {k: v.to(device) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: v.to(device) for k, v in lyr.items()}
                     for lyr in params["layers"]]
    return out


__all__ = ["LLMEngine", "Request", "RequestOutput", "RequestRejected"]
