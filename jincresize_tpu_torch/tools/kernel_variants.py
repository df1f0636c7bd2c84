"""Time edited copies of the fused wsplit3 kernel against the kernel as it is.

Each experiment of ``EXPERIMENTS`` is a set of text edits to
``csrc/fused_interior.cu`` (each replaces every match; one that matches
nothing stops the tool): the tool builds the edited sources of each, all at once, beside the
unedited ones (``build/variants/<name>/``), then on each plane of
``PLANES`` runs the wsplit3 operator on an 8-frame u8 luma batch through
every library, checks each against the fp32 plain form within
``kernels.fused.wsplit3_bound`` (where the experiment computes the same
function) and times it, with the bf16 kernel on the same batch beside them.
Times are the least of ``--rounds`` turns of ``--reps`` back-to-back calls
(CUDA events), the libraries in one order and then the other. It prints the
lines of ptxas that report serialized wgmmas, one line a plane, and last one
JSON object {plane: {experiment: ms/frame}, "card": ...}.

    python -m jincresize_tpu_torch.tools.kernel_variants [--only one-part] [--reps 10] [--rounds 2]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..kernels import _build, fused
from ..operator import build_plane_operator, radius_for_tap
from ..phase import plan_phases
from ._timing import add_device_arg, calls_ms, open_device
from .u8_kernel_timing import PLANES, bound

_STEP = "if constexpr (WG && decltype(lo_c)::value == 0 && decltype(hi_c)::value == NT - 1) {"
_ONE_SET = """    for (int s = s0; s < s1; ++s) {
      const uint32_t* const row = st + (s - r0) * rw;
      for (int q = 0; q < a.nq16 + a.k8; ++q) {
        const bool k8 = q == a.nq16;
        const int o = 8 * q + tq;
        uint32_t af[kWsMw][4];
#pragma unroll
        for (int mw = 0; mw < kWsMw; ++mw) {
          af[mw][0] = row[aoff[mw][0] + o];
          af[mw][1] = row[aoff[mw][1] + o];
          af[mw][2] = k8 ? 0u : row[aoff[mw][0] + o + 4];
          af[mw][3] = k8 ? 0u : row[aoff[mw][1] + o + 4];
        }
        const unsigned bq = wsa + 16u * r0t[s] + 32u * q * a.rows;
        const unsigned lbo = k8 ? 0u : 16u * a.rows;
        jt_wgmma_fence();
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mw = 0; mw < kWsMw; ++mw)
            jt_wgmma_m64n32k16(acc[mw], af[mw], jt_gmma_desc(bq + 4u * p * a.wn, lbo, 128u));
        jt_wgmma_commit();
        jt_wgmma_wait<0>();
      }
    }
"""
_TWO_SETS = """    const int nq = a.nq16 + a.k8;
    uint32_t af[2][kWsMw][4];
    auto load = [&](uint32_t(&f)[kWsMw][4], int s, int q) {
      const uint32_t* const row = st + (s - r0) * rw;
      const bool k8 = q == a.nq16;
      const int o = 8 * q + tq;
#pragma unroll
      for (int mw = 0; mw < kWsMw; ++mw) {
        f[mw][0] = row[aoff[mw][0] + o];
        f[mw][1] = row[aoff[mw][1] + o];
        f[mw][2] = k8 ? 0u : row[aoff[mw][0] + o + 4];
        f[mw][3] = k8 ? 0u : row[aoff[mw][1] + o + 4];
      }
    };
    auto mma = [&](const uint32_t(&f)[kWsMw][4], int s, int q) {
      const unsigned bq = wsa + 16u * r0t[s] + 32u * q * a.rows;
      const unsigned lbo = q == a.nq16 ? 0u : 16u * a.rows;
      jt_wgmma_fence();
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int mw = 0; mw < kWsMw; ++mw)
          jt_wgmma_m64n32k16(acc[mw], f[mw], jt_gmma_desc(bq + 4u * p * a.wn, lbo, 128u));
      jt_wgmma_commit();
    };
    int s = s0, q = 0;
    while (s < s1) {
      load(af[0], s, q);
      mma(af[0], s, q);
      jt_wgmma_wait<1>();
      if (++q == nq) q = 0, ++s;
      if (s == s1) break;
      load(af[1], s, q);
      mma(af[1], s, q);
      jt_wgmma_wait<1>();
      if (++q == nq) q = 0, ++s;
    }
    jt_wgmma_wait<0>();
"""

# name -> (what it does, [(old, new), ...] in csrc/fused_interior.cu, the
# weight rows' padding (None: the build's; "c": c - 1, every anchor row of
# the block), whether it computes the same function)
EXPERIMENTS = {
    "one-part": (
        "the wsplit3 kernel on its first weight part alone: the work of a "
        "bf16 mode on this kernel body (its sums are not the plane's)",
        [("for (int p = 0; p < 3; ++p)", "for (int p = 0; p < 1; ++p)")],
        None,
        False,
    ),
    "n32-every-row": (
        "every staged row's products as wgmma m64n32k16 over all 4 n-tiles, "
        "the weight rows padded by c - 1 zero slots",
        [(_STEP, "if constexpr (WG) {"), ("(lp != 0 && lp != 8 / g - 1)", "(lp < 0)")],
        "c",
        True,
    ),
    "two-a-sets": (
        "two sets of A registers: a wgmma step's loads overlap the previous "
        "step's products, each step waiting for the one before it",
        [(_ONE_SET, _TWO_SETS)],
        None,
        True,
    ),
}


def _edit(name: str, root: Path) -> Path:
    """The csrc/ copy of experiment ``name`` (the unedited one for None)."""
    d = root / (name or "as-is") / "csrc"
    shutil.rmtree(d.parent, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    if name is not None:
        p = d / "fused_interior.cu"
        s = p.read_text()
        for old, new in EXPERIMENTS[name][1]:
            if old not in s:
                raise RuntimeError(f"kernel_variants: {name}: an edit matches nothing")
            s = s.replace(old, new)
        p.write_text(s)
    return d


def _build_lib(src: Path, errors: list) -> None:
    """nvcc for each source of ``src`` (all at once), linked into
    ``src/../lib.so``; the ptxas log in ``build.log``."""
    procs = []
    for cu in sorted(src.glob("*.cu")):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(cu.with_suffix(".o")), str(cu)]
        pipe = subprocess.PIPE
        procs.append(subprocess.Popen(cmd, stdout=pipe, stderr=pipe, text=True))
    log = ""
    for proc in procs:
        out, err = proc.communicate()
        log += out + err
        if proc.returncode:
            errors.append(f"{src}: nvcc failed:\n{err[-2000:]}")
    (src.parent / "build.log").write_text(log)
    if not errors:
        objs = [str(p) for p in sorted(src.glob("*.o"))]
        lib = str(src.parent / "lib.so")
        cmd = [_build._nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", lib, *objs]
        subprocess.run(cmd, check=True, capture_output=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for n, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, n)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.jt_error_string.argtypes, lib.jt_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def _padded(fi: fused.FusedInterior, pad) -> fused.FusedInterior:
    """``fi`` with its weight rows padded by ``c - 1`` zero slots (``pad`` "c")."""
    if pad is None:
        return fi
    lay = fi.ws3
    lp = lay.c - 1
    rows = (fi.qy * (lay.lq + lp) + lp) * lay.g + 1
    wn = -(-(4 * lay.nk8 * rows + (rows + 1) // 2 * lay.last1) // 4) * 4
    lay = dataclasses.replace(lay, lp=lp, rows=rows, wn=wn)
    w = fused.ws3_weights(fused.split_bf16x3(fi.kernels.cpu().numpy()), lay, fi.qy)
    wtc = torch.from_numpy(w).to(torch.bfloat16).to(fi.wtc.device)
    return dataclasses.replace(fi, ws3=lay, wtc=wtc)


def _launch(lib, fi: fused.FusedInterior, src: torch.Tensor) -> torch.Tensor:
    """``fused.fused_interior``'s wsplit3 launch through ``lib``, with
    ``fi.ws3`` as the layout (which ``_padded`` may have changed)."""
    lay, (F, H, W) = fi.ws3, src.shape
    out = torch.empty((F, *fi.out_shape), dtype=torch.float32, device=src.device)
    geo = (F, H, W, fi.py, fi.px, fi.qy, fi.qx, fi.base_y, fi.base_x, fi.nyb, fi.nxb)
    rc = lib.jt_fused_interior_wsplit3(
        src.data_ptr(), fi.wtc.data_ptr(), out.data_ptr(), *geo,
        lay.kh, lay.kw, lay.g, lay.ngroups, lay.nq16, int(lay.k8), int(lay.last1),
        lay.lq, lay.lp, lay.rows, lay.wn, lay.cw, lay.swf, lay.ch,
        fused.ws3_frames(lay, fi.nyb, fi.nxb, F), lay.warps, _build.stream_of(src),
    )  # fmt: skip
    if rc:
        raise RuntimeError(f"kernel_variants: launch failed ({lib.jt_error_string(rc).decode()})")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m jincresize_tpu_torch.tools.kernel_variants")
    ap.add_argument("--only", nargs="*", choices=list(EXPERIMENTS), default=list(EXPERIMENTS))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    device, card = open_device(args)
    root = _build.BUILD_ROOT.parent / "variants"
    names = [None, *args.only]
    dirs = {n: _edit(n, root) for n in names}
    errors: list[str] = []
    threads = [threading.Thread(target=_build_lib, args=(d, errors)) for d in dirs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    libs = {n: _load(d.parent / "lib.so") for n, d in dirs.items()}
    for n, d in dirs.items():
        for line in (d.parent / "build.log").read_text().splitlines():
            if "C7511" in line:
                print(f"{n or 'as-is'}: {line.strip()}")
    rng = np.random.default_rng(args.seed)
    res = {}
    for plane, (kind, sw, sh, dw, dh, tap) in PLANES.items():
        if kind != "fused":
            continue
        op = build_plane_operator(sw, sh, dw, dh, radius_for_tap(tap))
        plan = plan_phases(op)
        fi = fused.make_fused_interior(op, plan, device, "wsplit3")
        f32 = fused.make_fused_interior(op, plan, device, "fp32")
        bf = fused.make_fused_interior(op, plan, device, "bf16")
        ops = {n: _padded(fi, EXPERIMENTS[n][2] if n else None) for n in names}
        shape = (args.frames, op.src_height, op.src_width)
        src = torch.from_numpy(rng.integers(0, 256, shape).astype(np.float32)).to(device)
        ref, wb = fused.fused_interior_plain(f32, src), bound(f32, src)
        for n in names:
            if n is None or EXPERIMENTS[n][3]:
                err = float((_launch(libs[n], ops[n], src) - ref).abs().max())
                assert err <= wb, (plane, n, err, wb)
        del ref
        times: dict[str, list[float]] = {}
        for turn in range(args.rounds):
            for seq in (names, names[::-1]):
                for n in seq:
                    fn = lambda n=n: _launch(libs[n], ops[n], src)  # noqa: E731
                    times.setdefault(n or "as-is", []).append(calls_ms(fn, device, args.reps))
            t = calls_ms(lambda: fused.fused_interior(bf, src), device, args.reps)
            times.setdefault("bf16 kernel", []).append(t)
        res[plane] = {n: min(v) / args.frames for n, v in times.items()}
        print(f"{plane} (wgmma {fi.ws3.wgmma}): "
              + ", ".join(f"{n} {v:.4f}" for n, v in res[plane].items()) + f" ms/frame [{card}]")
        del src
    res["card"] = card
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
