"""K2's kernels against variants of their own source, on the card: spills,
registers, agreement with the plain version and time at the qwen2-1.5b
(D 128, 64) and phi-3-vision-4.2b (D 96) prefill shapes, in bf16 (the
tensor-core kernel) and in f32 (the scalar kernel).

    PYTHONPATH=src python -m repro_torch.launch.k2_variants \\
        --out chiprun_out/k2_variants.json

The variants are made from ``kernels/csrc/flash_attention.cu`` by text
substitution, so they follow the source:

* ``committed``: the source as it is (the softmax's exponential
  ``ex2.approx.ftz`` at D 96, ``exp2f`` at D 64 and 128);
* ``ex2_approx``: ``ex2.approx.ftz`` (the SFU instruction alone; ``exp2f``
  adds range handling) at every D;
* ``exp2f``: ``exp2f`` at every D (D 96 as the first design has it);
* ``q_in_registers``: Q's A fragments loaded once into registers and
  Q·Kᵀ issued in wgmma's register-A form (its fragment loads follow the
  128-byte swizzle, so it runs at D 64 and 128 only);
* ``ping_pong``: the two consumer warpgroups take turns to issue their
  wgmmas (FlashAttention-3's ping-pong on named barriers 1 and 2): each
  waits for its turn before it issues a tile's products and hands the
  turn over after, so that one's softmax runs under the other's products;
* ``stages_4``: a K/V ring of 4 stages instead of 3 (at D 96 the 32
  freed columns make room: 124 KB of shared memory, at D 128 164 KB);
* ``scalar_unroll_4``: the scalar kernel's two product loops unrolled 4
  times instead of 8;
* ``scalar_lane_rows_4``, ``scalar_lane_rows_8``: 4 (16 a warp, 3 blocks
  an SM at most 168 registers) or 8 query rows a lane (32 a warp, 2
  blocks) at every D (the committed kernel: 8 up to D 96, 4 at D 128);
* ``scalar_one_stream``: the scalar kernel with one key stream instead of
  two (64 threads a block);
* ``scalar_no_pv``, ``scalar_no_qk``, ``scalar_no_loads``: diagnostics,
  wrong by design: the scalar kernel without its P·V loop, without its
  Q·Kᵀ loop (the scores stay 0), or without the K and V loads of its key
  loop; their times split the kernel's.

The tensor-core variants are timed on the bf16 shapes, the scalar ones on
the f32 shapes, the committed source on both.

Each is compiled with the build's flags into ``build/kernels/variants/``;
the report gives ptxas's spills, the highest register SASS uses
(``cuobjdump``), the largest |Δ| against the plain version (bf16: over
1e-3 + 1.6e-2·|plain|, the bf16 check of ``chip_smoke.py``) and the mean
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

# (B, Hq, Hkv, S, D), causal, bf16: the shortest and the first prompt
# phase 7 of chip_smoke.py serves, and the qwen2-1.5b prefill shape at D
# 128 and 64; phi-3-vision-4.2b's heads (MHA, 32 of 96) at that first
# prompt and at S 4,096
SHAPES = ((1, 12, 2, 550, 128), (1, 12, 2, 1781, 128),
          (1, 12, 2, 4096, 128), (1, 12, 2, 4096, 64),
          (1, 32, 32, 1781, 96), (1, 32, 32, 4096, 96))
# f32 (the scalar kernel): chip_smoke.py's phi3-f32 and f32-ragged cases
F32_SHAPES = ((1, 32, 32, 1000, 96), (1, 12, 2, 1000, 128))
# head dims a variant runs at (the others: every D of its shapes)
ONLY_D = {"q_in_registers": (64, 128)}
# variants of the scalar kernel (timed in f32); the others are of the
# tensor-core kernel (timed in bf16)
SCALAR = ("scalar_unroll_4", "scalar_lane_rows_4", "scalar_lane_rows_8",
          "scalar_one_stream", "scalar_no_pv", "scalar_no_qk",
          "scalar_no_loads")

_APPROX = "  return D == 96;\n"
_ISSUE = "  auto issue_s = [&](int t) {"
_ISSUE_S = """#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, kmajor_desc<D>(q_tile, kk),
                   kmajor_desc<D>(k_tile, kk), kk > 0);"""
_ISSUE_S_RS = """#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_rs_n64_kmajor(s, qf[kk], kmajor_desc<D>(k_tile, kk), kk > 0);"""
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


# ping-pong: consumer c waits on named barrier 1 + c before it issues a
# tile's wgmmas and arrives on the other's (2 - c) after; consumer 1 opens
# with an arrival so that consumer 0 goes first, and skips its last one,
# so each barrier sees as many arrivals as waits
_TURNS = """  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + c) : "memory");
  };
  auto turn_pass = [&](bool last) {
    if (!last || c == 0)
      asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - c) : "memory");
  };
  if (c == 1 && n_tiles > 0)
    asm volatile("bar.arrive 1, 256;\\n" ::: "memory");
"""
_FIRST_WGMMAS = "    wgmma_fence();\n    issue_s(0);\n"
_LOOP_WGMMAS = ("      wgmma_fence();\n      issue_s(t);\n"
                "      issue_pv(t - 1);\n")
_LAST_WGMMAS = "    wgmma_fence();\n    issue_pv(n_tiles - 1);\n"
_STAGES = "constexpr int kStages = 3;"
_D_LOOP = "#pragma unroll 8\n      for (int d = 0; d < D; ++d) {"
_KK_LOOP = "#pragma unroll 8\n      for (int kk = 0; kk < kBlockK; ++kk) {"
_LANE_ROWS = "static constexpr int kLane = D == 128 ? 4 : 8;"
_STREAMS = "constexpr int kStreams = 2;"
_PV_LOOP = "    if (active) {                 // O += P_t·V_t"
_QK_LOOP = "      for (int d = 0; d < D; ++d) {"
_V_LOAD = "    stage_rows<T, D>(vs, v_head, k0, sk_actual, tid);\n"
_K_LOAD = """      stage_dmajor<T, D, kBlockK, kLdK, kStreamThreads>(
          ks, k_head, k0 + kStreams * kBlockK, sk_actual, tid);
"""


def _replace(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"k2_variants: source holds {old!r} "
                           f"{src.count(old)} times, not once")
    return src.replace(old, new)


def variant_sources() -> dict:
    """{name: .cu text} of every variant."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    ex2 = _replace(src, _APPROX, "  return true;\n")
    exp2f = _replace(src, _APPROX, "  return false;\n")
    q_regs = _replace(src, _PV, _RS_KMAJOR + _PV)
    q_regs = _replace(q_regs, _ISSUE, "  uint32_t qf[D / 16][4];\n" + _ISSUE)
    q_regs = _replace(q_regs, _ISSUE_S, _ISSUE_S_RS)
    q_regs = _replace(q_regs, _Q_WAIT, _Q_LOAD)
    ping = _replace(src, _Q_WAIT, _TURNS + _Q_WAIT)
    ping = _replace(ping, _FIRST_WGMMAS,
                    "    turn_wait();\n" + _FIRST_WGMMAS
                    + "    turn_pass(false);\n")
    ping = _replace(ping, _LOOP_WGMMAS,
                    "      turn_wait();\n" + _LOOP_WGMMAS
                    + "      turn_pass(false);\n")
    ping = _replace(ping, _LAST_WGMMAS,
                    "    turn_wait();\n" + _LAST_WGMMAS
                    + "    turn_pass(true);\n")
    stages = _replace(src, _STAGES, "constexpr int kStages = 4;")
    unroll = _replace(src, _D_LOOP, _D_LOOP.replace("8", "4", 1))
    unroll = _replace(unroll, _KK_LOOP, _KK_LOOP.replace("8", "4", 1))
    streams = {"scalar_lane_rows_4": _replace(
                   src, _LANE_ROWS, "static constexpr int kLane = 4;"),
               "scalar_lane_rows_8": _replace(
                   src, _LANE_ROWS, "static constexpr int kLane = 8;"),
               "scalar_one_stream": _replace(src, _STREAMS,
                                             "constexpr int kStreams = 1;")}
    no_pv = _replace(src, _PV_LOOP, "    if (false) {")
    no_qk = _replace(src, _QK_LOOP, "      for (int d = 0; d < 0; ++d) {")
    no_loads = _replace(_replace(src, _V_LOAD, ""), _K_LOAD, "")
    return {"committed": src, "ex2_approx": ex2, "exp2f": exp2f,
            "q_in_registers": q_regs, "ping_pong": ping, "stages_4": stages,
            "scalar_unroll_4": unroll, **streams, "scalar_no_pv": no_pv,
            "scalar_no_qk": no_qk, "scalar_no_loads": no_loads}


def _template(fn: str):
    """``tc_d<D>`` or ``scalar_<f32|bf16>_d<D>`` for a K2 kernel's mangled
    name, else None."""
    tc = re.search(r"flash_attention_tcILi(\d+)E", fn)
    if tc:
        return f"tc_d{tc.group(1)}"
    sc = re.search(r"flash_attention_kernelI(13__nv_bfloat16|f)Li(\d+)E", fn)
    if sc:
        return f"scalar_{'f32' if sc.group(1) == 'f' else 'bf16'}_d" \
               f"{sc.group(2)}"
    return None


def _compile_all(sources: dict) -> dict:
    """Build every variant at once (one nvcc each); {name: record}."""
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    recs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"k2_variants: {name} does not build:\n{log}")
        recs[name] = _read_build(so, log)
    return recs


def _read_build(so: Path, log: str) -> dict:
    """Spills per template from ptxas's log, the highest register per
    template from the SASS, and whether ptxas serialized the wgmmas."""
    rec, t = {"so": str(so), "serialized_wgmma": False}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            t = _template(m.group(1))
        elif "wgmma.mma_async instructions are serialized" in line:
            rec["serialized_wgmma"] = True
        elif t and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                   r"spill loads", line)):
            rec[f"spill_bytes_{t}"] = int(m.group(1)) + int(m.group(2))
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    t = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            t = _template(m.group(1))
        elif t:
            key = f"max_register_{t}"
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
    recs, fns = _compile_all(variant_sources()), {}
    for name, rec in recs.items():
        fn = ctypes.CDLL(rec["so"]).k2_flash_attention
        fn.argtypes, fn.restype = k2.ARGTYPES, ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    host_us = {}
    for b, hq, hkv, s, d, dtype in ([(*x, torch.bfloat16) for x in SHAPES]
                                    + [(*x, torch.float32)
                                       for x in F32_SHAPES]):
        f32 = dtype == torch.float32
        shape = f"S{s}_D{d}" + ("_f32" if f32 else "")
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for h in (hq, hkv, hkv))
        plain = k2.flash_attention_plain(q, k, v, causal=True).float()
        here = [n for n in fns if d in ONLY_D.get(n, (d,))
                and (n == "committed" or (n in SCALAR) == f32)]
        for name in here:
            diff = (_call(fns[name], q, k, v).float() - plain).abs()
            if f32:
                recs[name][f"max_abs_err_{shape}"] = float(diff.max())
            else:
                recs[name][f"scaled_err_{shape}"] = float(
                    (diff / (1e-3 + 1.6e-2 * plain.abs())).max())
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        for name in here + here[::-1]:
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
