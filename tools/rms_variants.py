#!/usr/bin/env python3
"""Check and time the port's rms_norm kernels at the llama_1b and
llama_125m norm shapes for several backward chunkings and for edited
copies of their CUDA source.

    python3 tools/rms_variants.py [--blocks 1,2,4] [--json PATH] \\
        [--profile] [--variant 'NAME:OLD=>NEW[@@OLD=>NEW...]']

First the build's registers, spills, stack and shared memory per kernel
of each source (``chip_smoke.report_rms_build``). Then, for each source
and each count of backward blocks aimed at an SM (``--blocks``, which
sets ``rms_norm._BWD_BLOCKS_PER_SM`` and so ``dw_chunks``): both kernels
against their plain versions at every shape of ``chip_smoke.RMS_SHAPES``
in f32, bf16 and both mixes, within ``chip_smoke``'s tolerances, two
backward launches bitwise equal; and each kernel's time by
``chip_smoke.time_ms`` (CUDA events, the L2 evicted) at the llama_1b
[2048, 2048] and llama_125m [8192, 768] f32 shapes, with GB/s and the
share of the bytes bound, beside ``F.rms_norm`` (forward; backward
through autograd) timed in the same run, and beside the card's own
elementwise path over the same bytes (``copy_`` of x for the forward's
read and write, ``torch.add(x, dy, out=...)`` for the backward's two
reads and one write); each also behind an L2 full of clean lines
(``time_ms(clean_l2=True)``), where the eviction writes nothing back. A
variant is ``paddle_tpu_torch/kernels/csrc/rms_norm.cu`` with the text
before ``=>`` replaced by the text after it (several edits apart by
``@@``), built beside the real source for the run and deleted after; a
variant that breaks results is timed, and its failure printed, but only
the real source is held to the tolerance. ``--json`` writes every row to
a file. ``--profile``: each source's kernels' device time by name
(``torch.profiler``) over 20 forward and 20 backward calls at the
llama_1b shape, the L2 evicted before each. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: the timed shapes: the llama_1b and llama_125m norms (f32)
TIME_SHAPES = {"1b": (2048, 2048), "125m": (8192, 768)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", default="",
                    help="backward blocks per SM, comma-separated "
                         "(default: the module's own)")
    ap.add_argument("--json", default="", help="write every row here")
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel at the llama_1b shape")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME:OLD=>NEW, an edited copy of the source")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import rms_norm as trn

    blocks = [int(v) for v in args.blocks.split(",")] if args.blocks \
        else [trn._BWD_BLOCKS_PER_SM]
    src = (_build.CSRC / "rms_norm.cu").read_text()
    sources, written = {"base": "rms_norm"}, []
    for spec in args.variant:
        name, edits = spec.split(":", 1)
        text = src
        for edit in edits.split("@@"):
            old, new = edit.split("=>", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = _build.CSRC / f"rms_norm_variant_{name}.cu"
        path.write_text(text)
        written.append(path)
        sources[name] = path.stem
    base = trn._library()
    try:
        print(cs.card_line(), flush=True)
        print(f"built in {_build.build(list(sources.values())):.2f} s",
              flush=True)
        libs = {}
        for name, stem in sources.items():
            try:
                cs.report_rms_build(_build, stem)
            except AssertionError as e:
                if name == "base":
                    raise
                print(f"[build] {stem}: {e}", flush=True)
            lib = _build.load(stem)
            for fn in ("rms_norm_fwd", "rms_norm_bwd",
                       "rms_norm_bwd_smem_bytes"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[name] = lib
        rows = run(torch, cs, trn, libs, blocks)
        if args.profile:
            for name, lib in libs.items():
                trn._library = lambda lib=lib: lib
                profile(torch, trn, name)
    finally:
        trn._library = lambda: base
        for path in written:
            path.unlink(missing_ok=True)
    if args.json:
        Path(args.json).write_text(json.dumps(
            dict(card=cs.card_line(), rows=rows), indent=1))
    return 0


def run(torch, cs, trn, libs, blocks):
    import torch.nn.functional as F
    default_blocks = trn._BWD_BLOCKS_PER_SM
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = {}
    for label, (rows, f) in TIME_SHAPES.items():
        x = torch.randn(rows, f, device="cuda", generator=g)
        w = 1 + 0.5 * torch.randn(f, device="cuda", generator=g)
        dy = torch.randn(rows, f, device="cuda", generator=g)
        xr = x.detach().requires_grad_()
        wr = w.detach().requires_grad_()
        out = F.rms_norm(xr, (f,), wr, 1e-5)
        lib = {"fwd": lambda: F.rms_norm(x, (f,), w, 1e-5),
               "bwd": lambda: torch.autograd.grad(out, (xr, wr), dy,
                                                  retain_graph=True)}
        lib_ms = {key: (cs.time_ms(torch, call, 50),
                        cs.time_ms(torch, call, 50, clean_l2=True))
                  for key, call in lib.items()}
        out_buf = torch.empty_like(x)
        for what, call in (
                ("copy_ (fwd bytes)", lambda: out_buf.copy_(x)),
                ("torch.add (bwd bytes)",
                 lambda: torch.add(x, dy, out=out_buf))):
            print(f"{label} [{rows}, {f}] f32: {what} "
                  f"{cs.time_ms(torch, call, 50):.4f} ms (clean L2 "
                  f"{cs.time_ms(torch, call, 50, clean_l2=True):.4f})",
                  flush=True)
        n = rows * f
        nbytes = {"fwd": 4 * (2 * n + f + rows),
                  "bwd": 4 * (3 * n + 2 * f + rows)}
        cases[label] = (x, w, dy, lib_ms, nbytes)
        print(f"{label} [{rows}, {f}] f32: F.rms_norm {lib_ms['fwd'][0]:.4f}"
              f" ms (clean L2 {lib_ms['fwd'][1]:.4f}), backward (autograd) "
              f"{lib_ms['bwd'][0]:.4f} ms (clean L2 {lib_ms['bwd'][1]:.4f}); "
              f"bounds "
              f"{cs.bound_ms(nbytes['fwd'], 4 * n, cs.F32_FLOPS)[0]:.4f} and "
              f"{cs.bound_ms(nbytes['bwd'], 12 * n, cs.F32_FLOPS)[0]:.4f} "
              f"ms (bytes)", flush=True)
    rows_out = []
    try:
        for src, lib in libs.items():
            trn._library = lambda lib=lib: lib
            for b in blocks:
                trn._BWD_BLOCKS_PER_SM = b
                tag = f"{src} blocks/SM {b}"
                try:
                    cs.phase_rms_parity(torch)
                    ok = "held to the plain version at every RMS_SHAPES case"
                except AssertionError as e:
                    if src == "base":
                        raise
                    ok = f"FAILS: {e}"
                print(f"[{tag}] {ok}", flush=True)
                for label, (x, w, dy, lib_ms, nbytes) in cases.items():
                    rows, f = x.shape
                    y, rstd = trn.rms_norm_fwd(x, w, 1e-5)
                    calls = {"fwd": lambda: trn.rms_norm_fwd(x, w, 1e-5),
                             "bwd": lambda: trn.rms_norm_bwd(x, w, rstd, dy)}
                    for key, call in calls.items():
                        ms = cs.time_ms(torch, call, 50)
                        clean = cs.time_ms(torch, call, 50, clean_l2=True)
                        bound = cs.bound_ms(nbytes[key],
                                            (4 if key == "fwd" else 12) *
                                            rows * f, cs.F32_FLOPS)[0]
                        print(f"  [{tag}] {key} {label}: {ms:.4f} ms, "
                              f"{nbytes[key] / ms / 1e6:.0f} GB/s, "
                              f"{100 * bound / ms:.1f}% of the bound, "
                              f"{ms / lib_ms[key][0]:.2f}x F.rms_norm"
                              f"{' backward' if key == 'bwd' else ''}; "
                              f"clean L2 {clean:.4f} ms "
                              f"({100 * bound / clean:.1f}%, "
                              f"{clean / lib_ms[key][1]:.2f}x); dw chunks "
                              f"{trn.dw_chunks(rows, f)}", flush=True)
                        rows_out.append(dict(
                            source=src, blocks_per_sm=b, kernel=key,
                            shape=label, ms=ms, ms_clean_l2=clean,
                            bound_ms=bound, library_ms=lib_ms[key][0],
                            library_ms_clean_l2=lib_ms[key][1], ok=ok,
                            chunks=trn.dw_chunks(rows, f)))
    finally:
        trn._BWD_BLOCKS_PER_SM = default_blocks
    return rows_out


def profile(torch, trn, name, calls=20):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    rows, f = TIME_SHAPES["1b"]
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(rows, f, device="cuda", generator=g)
    w = 1 + 0.5 * torch.randn(f, device="cuda", generator=g)
    dy = torch.randn(rows, f, device="cuda", generator=g)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    _, rstd = trn.rms_norm_fwd(x, w, 1e-5)
    trn.rms_norm_bwd(x, w, rstd, dy)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            trn.rms_norm_fwd(x, w, 1e-5)
            flush.zero_()
            trn.rms_norm_bwd(x, w, rstd, dy)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "rms_" in e.key:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            print(f"[profile {name}] {us / e.count:8.2f} us per launch, "
                  f"{e.count} launches: {e.key[:110]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
