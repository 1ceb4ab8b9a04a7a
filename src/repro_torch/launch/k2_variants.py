"""K2's tensor-core kernel against variants of its own source, on the card:
spills, registers, agreement with the plain version and time at the
qwen2-1.5b prefill shapes.

    PYTHONPATH=src python -m repro_torch.launch.k2_variants \\
        --out chiprun_out/k2_variants.json

The variants are made from ``kernels/csrc/flash_attention.cu`` by text
substitution, so they follow the source:

* ``committed``: the source as it is;
* ``ex2_approx``: the softmax's ``exp2f`` replaced by ``ex2.approx.ftz``
  (the SFU instruction alone; ``exp2f`` adds range handling);
* ``q_in_registers``: Q's A fragments loaded once into registers and
  Q·Kᵀ issued in wgmma's register-A form.

Each is compiled with the build's flags into ``build/kernels/variants/``;
the report gives ptxas's spills, the highest register SASS uses
(``cuobjdump``), the largest |Δ| against the plain version over
1e-3 + 1.6e-2·|plain| (the bf16 check of ``chip_smoke.py``) and the mean
of 100 calls timed with CUDA events, the variants in turn and then in
reverse order; and, for the committed kernel through its wrapper
(``flash_attention``), the host's time per call (100 calls enqueued
without a synchronisation), which bounds the kernel's time per call from
below when calls follow each other. Runs on the CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time
from pathlib import Path

import torch

from ..device import card_description, resolve_device
from ..kernels import build, flash_attention as k2

# (B, Hq, Hkv, S, D), causal: the shortest and the first prompt phase 7 of
# chip_smoke.py serves, and the qwen2-1.5b prefill shape at D 128 and 64
SHAPES = ((1, 12, 2, 550, 128), (1, 12, 2, 1781, 128),
          (1, 12, 2, 4096, 128), (1, 12, 2, 4096, 64))

_SOFTMAX = "// Online softmax on one 64×64 score fragment"
_EX2 = """__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

"""
_ISSUE = "  auto issue_s = [&](int t) {"
_ISSUE_S = """#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc(q_tile, kk), kmajor_desc(k_tile, kk),
                   kk > 0);"""
_ISSUE_S_RS = """#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64_kmajor(s, qf[kk], kmajor_desc(k_tile, kk), kk > 0);"""
_Q_WAIT = "  mbar_wait(sm.q_full, 0);\n  if (n_tiles > 0) {"
_Q_LOAD = """  mbar_wait(sm.q_full, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + 8 * (r % 2);
      const int col = 16 * kk + c0 + 8 * (r / 2);
      qf[kk][r] = *reinterpret_cast<const uint32_t*>(
          sm.q + c * kTile + (col / kSubCols) * kSubBytes + row * 128 +
          (((col % kSubCols) / 8) ^ (row % 8)) * 16 + (col % 8) * 2);
    }
  if (n_tiles > 0) {"""
_PV = "template <int D>\n__device__ __forceinline__ void wgmma_pv("
_RS_KMAJOR = """__device__ __forceinline__ void wgmma_rs_n64_kmajor(
    float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\\n.reg .pred p;\\nsetp.ne.b32 p, %37, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\\n}\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

"""


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"k2_variants: source no longer holds {old!r}")
    return src.replace(old, new)


def variant_sources() -> dict:
    """{name: .cu text} of every variant."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    ex2 = _replace(src, _SOFTMAX, _EX2 + _SOFTMAX)
    ex2 = _replace(ex2, "exp2f(x - m_new)", "ex2_approx(x - m_new)")
    ex2 = _replace(ex2, "exp2f(m[i] - m_new)", "ex2_approx(m[i] - m_new)")
    q_regs = _replace(src, _PV, _RS_KMAJOR + _PV)
    q_regs = _replace(q_regs, _ISSUE, "  uint32_t qf[D / 16][4];\n" + _ISSUE)
    q_regs = _replace(q_regs, _ISSUE_S, _ISSUE_S_RS)
    q_regs = _replace(q_regs, _Q_WAIT, _Q_LOAD)
    return {"committed": src, "ex2_approx": ex2, "q_in_registers": q_regs}


def _compile(name: str, text: str) -> dict:
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(text)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True,
                         check=True)
    rec, d = {"so": str(so), "serialized_wgmma": False}, None
    for line in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            tc = re.search(r"flash_attention_tcILi(\d+)E", m.group(1))
            d = tc.group(1) if tc else None
        elif "wgmma.mma_async instructions are serialized" in line:
            rec["serialized_wgmma"] = True
        elif d and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)):
            rec[f"spill_bytes_d{d}"] = int(m.group(1)) + int(m.group(2))
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    d = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            tc = re.search(r"flash_attention_tcILi(\d+)E", m.group(1))
            d = tc.group(1) if tc else None
        elif d:
            key = f"max_register_d{d}"
            for r in re.findall(r"\bR(\d+)\b", line):
                rec[key] = max(rec.get(key, 0), int(r))
    return rec


def _call(fn, q, k, v) -> torch.Tensor:
    out = torch.empty_like(q)
    scale, ska, off = k2._resolve(q, k, None, None, None)
    args, _keep = k2._launch_args(q, k, v, out, True, scale, ska, off)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"k2_variants: launch failed with {err}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the report here")
    args = ap.parse_args()
    resolve_device(None)                      # the card, or raise
    recs, fns = {}, {}
    for name, text in variant_sources().items():
        recs[name] = _compile(name, text)
        fn = ctypes.CDLL(recs[name]["so"]).k2_flash_attention
        fn.argtypes, fn.restype = k2.ARGTYPES, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    order = list(fns) + list(reversed(list(fns)))
    host_us = {}
    for b, hq, hkv, s, d in SHAPES:
        shape = f"S{s}_D{d}"
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .bfloat16() for h in (hq, hkv, hkv))
        plain = k2.flash_attention_plain(q, k, v, causal=True).float()
        for name, fn in fns.items():
            diff = (_call(fn, q, k, v).float() - plain).abs()
            recs[name][f"scaled_err_{shape}"] = float(
                (diff / (1e-3 + 1.6e-2 * plain.abs())).max())
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        for name in order:
            for _ in range(5):
                _call(fns[name], q, k, v)
            torch.cuda.synchronize()
            start.record()
            for _ in range(100):
                _call(fns[name], q, k, v)
            stop.record()
            torch.cuda.synchronize()
            recs[name].setdefault(f"ms_{shape}", []).append(
                start.elapsed_time(stop) / 100)
        k2.flash_attention(q, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            k2.flash_attention(q, k, v)
        host_us[shape] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
    report = {"card": card_description(), "variants": recs,
              "wrapper_host_us_per_call": host_us}
    print(f"card: {report['card']}")
    for name, rec in recs.items():
        print(name, json.dumps({k: v for k, v in rec.items() if k != "so"}))
    print("wrapper host us per call", json.dumps(host_us))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
