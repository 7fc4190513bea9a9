#!/usr/bin/env python3
"""Check and time the port's dequant-matmul at the 7B serving shapes for
each K split count and for edited copies of its CUDA source.

    python3 tools/matmul_variants.py [--splits 0,1,2,4,8] \\
        [--shapes q/k/v/o,down] [--bits 8,4] [--json PATH] \\
        [--variant 'NAME:OLD=>NEW[@@OLD=>NEW...]']

For every shape of ``chip_smoke.MATMUL_SHAPES_7B``, int8 and int4, and
each split count (0: the kernel's own choice, which is printed): the
kernel against its plain version within ``chip_smoke.MATMUL_RTOL``, a
second call bitwise equal, and its time by ``chip_smoke.time_ms`` (CUDA
events, the L2 evicted) beside ``torch.matmul`` on the bf16 weight.
First the build's registers, spills and shared memory per
instantiation; also a few odd shapes (M 1 and 200, odd K, ragged N, an
unaligned row stride) held to the plain version. ``--json`` writes
every row to a file. A variant is
``paddle_tpu_torch/kernels/csrc/int8_matmul.cu`` with the text before
``=>`` replaced by the text after it (several edits apart by ``@@``),
built beside the real source for the run and deleted after; a variant
is timed, its difference from the plain version printed but not held to
the tolerance. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: (M, K, N, row stride): small, odd and strided shapes, parity only
ODD_SHAPES = [(1, 1023, 200, 200), (200, 257, 40, 40), (8, 33, 24, 24),
              (130, 1023, 300, 301), (16, 4096, 264, 512)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="0,1,2,4,8",
                    help="split counts, comma-separated (0: automatic)")
    ap.add_argument("--shapes", default="",
                    help="shape names to time, comma-separated (all)")
    ap.add_argument("--bits", default="8,4", help="bit widths to time")
    ap.add_argument("--json", default="", help="write every row here")
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
    from paddle_tpu_torch.kernels import int8_matmul as tmm

    splits = [int(v) for v in args.splits.split(",")]
    widths = [int(v) for v in args.bits.split(",")]
    names = args.shapes.split(",") if args.shapes else None
    src = (_build.CSRC / "int8_matmul.cu").read_text()
    sources, written = {"base": "int8_matmul"}, []
    for spec in args.variant:
        name, edits = spec.split(":", 1)
        text = src
        for edit in edits.split("@@"):
            old, new = edit.split("=>", 1)
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 f"source")
            text = text.replace(old, new)
        path = _build.CSRC / f"int8_matmul_variant_{name}.cu"
        path.write_text(text)
        written.append(path)
        sources[name] = path.stem
    try:
        print(cs.card_line(), flush=True)
        print(f"built in {_build.build(list(sources.values())):.2f} s",
              flush=True)
        report_build(cs, _build, tmm)
        for stem in list(sources.values())[1:]:
            for line in _build.ptxas_log(stem).splitlines():
                if "C7515" in line:
                    print(f"[build] {stem}: {line.strip()[:160]}", flush=True)
        base = tmm._library()
        libs = {}
        for name, stem in sources.items():
            lib = _build.load(stem)
            for fn in ("dequant_matmul", "dequant_matmul_splits",
                       "dequant_matmul_smem_bytes"):
                getattr(lib, fn).argtypes = getattr(base, fn).argtypes
                getattr(lib, fn).restype = getattr(base, fn).restype
            libs[name] = lib
        rows = run(torch, cs, tmm, libs, splits, widths, names)
    finally:
        tmm._library = lambda: base
        for path in written:
            path.unlink(missing_ok=True)
    if args.json:
        Path(args.json).write_text(json.dumps(
            dict(card=cs.card_line(), rows=rows), indent=1))
    return 0


def run(torch, cs, tmm, libs, splits, widths, names):
    g = torch.Generator(device="cuda").manual_seed(13)
    for m, k, n, ldw in ODD_SHAPES:
        for bits in (8, 4):
            x, wq, sc, _ = cs.matmul_case(torch, g, m, k, n, ldw, bits)
            check(torch, cs, tmm, x, wq, sc, k, bits, 0,
                  f"M {m} K {k} N {n} ldw {ldw} int{bits}")
    rows = []
    for name, m, k, n, ldw in cs.MATMUL_SHAPES_7B:
        if names and name not in names:
            continue
        for bits in widths:
            x, wq, sc, w = cs.matmul_case(torch, g, m, k, n, ldw, bits)
            lib_ms = cs.time_ms(torch, lambda: torch.matmul(x, w), 100)
            nbytes = m * k * 2 + wq.shape[0] * n + 4 * n + m * n * 2
            bound, by = cs.bound_ms(nbytes, 2 * m * k * n)
            print(f"{name} M {m} K {k} N {n} int{bits}: bound {bound:.4f} "
                  f"ms ({by}), torch.matmul bf16 {lib_ms:.4f} ms",
                  flush=True)
            for src, lib in libs.items():
                tmm._library = lambda lib=lib: lib
                for s in splits:
                    label = f"{name} int{bits} {src} splits {s}"
                    err = check(torch, cs, tmm, x, wq, sc, k, bits, s, label,
                                hold=src == "base")
                    ms = cs.time_ms(torch, lambda: tmm._launch_cuda(
                        x, wq, sc, k, bits, s), 100)
                    used = s or tmm.kernel_splits(bits, m, n, k)
                    print(f"  {label} ({used} used): {ms:.4f} ms, "
                          f"{nbytes / ms / 1e6:.0f} GB/s, "
                          f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s, "
                          f"{ms / lib_ms:.2f}x torch.matmul, "
                          f"max|diff| {err:.2e}", flush=True)
                    rows.append(dict(shape=name, m=m, k=k, n=n, ldw=ldw,
                                     bits=bits, source=src, splits=used,
                                     auto=s == 0, ms=ms, library_ms=lib_ms,
                                     bound_ms=bound, bound_by=by,
                                     max_abs_err=err))
    return rows


def check(torch, cs, tmm, x, wq, sc, k, bits, splits, label, hold=True):
    """The kernel against the plain version; a second call bitwise
    equal (``hold``: raise otherwise). Returns max |diff|."""
    got = tmm._launch_cuda(x, wq, sc, k, bits, splits)
    again = tmm._launch_cuda(x, wq, sc, k, bits, splits)
    torch.cuda.synchronize()
    want = tmm.dequant_matmul_reference(x, wq, sc, k, bits).float()
    err = (got.float() - want).abs().max().item()
    tol = cs.MATMUL_RTOL["bfloat16"] * max(1.0, want.abs().max().item())
    if not hold:
        return err
    if not (torch.isfinite(got.float()).all() and err <= tol):
        raise AssertionError(f"{label}: max|diff| {err} over {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two calls differ")
    return err


def report_build(cs, _build, tmm):
    ptx, mma = cs.build_info(_build, "int8_matmul")
    lib = tmm._library()
    for line in _build.ptxas_log("int8_matmul").splitlines():
        if "wgmma" in line.lower() or "performance" in line.lower():
            print(f"[build] ptxas: {line.strip()}", flush=True)
    for name in sorted(set(ptx) | set(mma)):
        info = ptx.get(name, {})
        print(f"[build] {name}: {info.get('registers')} registers, spills "
              f"{info.get('spills')}, {mma.get(name, 0)} HMMA/HGMMA",
              flush=True)
    for bits in (8, 4):
        print(f"[build] int{bits} shared memory per block: "
              f"{lib.dequant_matmul_smem_bytes(bits, 0)} B (wgmma, M > 16), "
              f"{lib.dequant_matmul_smem_bytes(bits, 1)} B (mma.sync, "
              f"M <= 16)", flush=True)


if __name__ == "__main__":
    sys.exit(main())
