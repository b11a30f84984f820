"""Variants of the fp32 tensor-core kernels, timed in one call on one card.

    python3 chip_tf32_variants.py      # one CUDA card

``csrc/gemm_f32.cu::ds_ln_gemm_f32`` and ``csrc/attention_f32.cu::
ds_flash_attention_f32`` multiply fp32 operands as three tf32 products.
This script builds variants of the two sources (the source as committed,
changed by text replacement; each built alone with ``nvcc`` into
``build/tf32_variants/``), runs each through the port's own wrappers
(``cuda_lib.ln_gemm``, ``fused_spatial.flash_attention``) at shapes of the
full-width batch-8 i2v fp32 forward, holds it against the plain version,
and times the variants in turns (as built, then each variant, then the same
in reverse order). The variants answer the design's questions:

* ``integer rounding``: ``hopper.cuh::tf32_rna`` in integer operations
  (the same bits, inf and NaN kept) instead of ``cvt.rna.tf32.f32``;
* ``one accumulator``: every product of a tile into one accumulator, no
  per-stage fold: the error the tensor core's rounding towards zero adds;
* ``weights split in shared memory``: the GEMM reads the raw weights and
  three warps of its producer warpgroup split each B stage in shared
  memory, the other way to split them (the design takes them split once,
  ``cuda_lib.tf32_split_weights``, twice the fp32 weights in memory);
* ``A not split``, ``K, V not split`` (results wrong, the gate not
  applied): what the split of the activations and of the flash kernel's
  keys and values costs.

Prints one line per shape, then one JSON object of every time and error.
Fails if a variant does not build or an as-built run misses the fp32 gate.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from dynamicscaler_tpu_torch.ops import cuda_lib, fused_spatial

TOL_F32 = 1e-5
OUT = cuda_lib.REPO_ROOT / "build" / "tf32_variants"
HOPPER = (cuda_lib.CSRC / "hopper.cuh").read_text()


def _rna_body(src):
    start = src.index("__device__ __forceinline__ uint32_t tf32_rna(float x) {")
    return src[start:src.index("\n}\n", start) + 2]


INT_RNA = """__device__ __forceinline__ uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7F800000u) == 0x7F800000u ? u : (u + 0x1000u) & 0xFFFFE000u;
}"""
SPLIT_A = ("""        split_tf32(*reinterpret_cast<const float*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4)),
                   f[0][j][h + 2 * c], f[1][j][h + 2 * c]);""",
           """        {
          f[0][j][h + 2 * c] = *reinterpret_cast<const uint32_t*>(arow + h * 8 * ROW + (((2 * j + c) ^ g) << 4));
          f[1][j][h + 2 * c] = 0u;
        }""")
ONE_ACC = [("issue_stage<BN>(part, f0,", "issue_stage<BN>(acc, f0,"),
           ("issue_stage<BN>(part, f1,", "issue_stage<BN>(acc, f1,"),
           ("    WgmmaTf32RegA<BN>::mma(part, f[1][j], bh + 2 * j, j);",
            "    WgmmaTf32RegA<BN>::mma(part, f[1][j], bh + 2 * j, 1);")]
# the raw weights by TMA, three warps of the producer warpgroup splitting each
# B stage in shared memory (in place, the remainders beside it) before the
# consumers (a third mbarrier a stage) read it
SMEM_SPLIT = [
    ("  return SMEM_ALIGN + stages * stage_bytes(bn) + 2 * stages * 8;",
     "  return SMEM_ALIGN + stages * stage_bytes(bn) + 3 * stages * 8;"),
    ("constexpr int CONSUMER_REGS = 232;", "constexpr int CONSUMER_REGS = 224;"),
    ("constexpr int PRODUCER_REGS = 40;", "constexpr int PRODUCER_REGS = 56;"),
    ("      mbar_init(&empty[s], 8);  // one arrival per consumer warp",
     "      mbar_init(&empty[s], 8);  // one arrival per consumer warp\n      mbar_init(&empty[S + s], 3);"),
    ("  mbar_wait(&full[it % S], (it / S) & 1);\n}",
     "  mbar_wait(&full[it % S], (it / S) & 1);\n  mbar_wait(&full[2 * S + it % S], (it / S) & 1);\n}"),
    ("          mbar_expect_tx(&full[s], A_BYTES + 2 * B_BYTES);", "          mbar_expect_tx(&full[s], A_BYTES + B_BYTES);"),
    ("          for (int half = 0; half < 2; ++half) {  // W_hi, then W_lo",
     "          for (int half = 0; half < 1; ++half) {"),
    ("    }\n  } else {\n    // ---- consumers: warpgroup wg owns tile rows", """    } else if (tid >= 32) {
      const int sid = tid - 32, lane = tid & 31;
      int it = 0;
      for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % S;
          mbar_wait(&full[s], (it / S) & 1);
          uint4* hi = reinterpret_cast<uint4*>(smem + s * STAGE + A_BYTES);
          uint4* lo = hi + B_BYTES / 16;
          for (int i = sid; i < B_BYTES / 16; i += 96) {
            const float4 v = *reinterpret_cast<const float4*>(hi + i);
            uint4 h, l;
            split_tf32(v.x, h.x, l.x);
            split_tf32(v.y, h.y, l.y);
            split_tf32(v.z, h.z, l.z);
            split_tf32(v.w, h.w, l.w);
            hi[i] = h;
            lo[i] = l;
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[S + s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows"""),
    ("    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 2};",
     "    const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, 1};")]
RAW_W = ("weights split in shared memory",)  # the variants that take the raw weights
GEMM_VARIANTS = {"as built": ([], None), "integer rounding": ([], INT_RNA), "one accumulator": (ONE_ACC, None),
                 "weights split in shared memory": (SMEM_SPLIT, None), "A not split": ([SPLIT_A], None)}
WRONG = ("A not split", "K, V not split")
SPLIT_KV = [("            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {\n              const float4 v",
             "            for (int i = sid; i < 0; i += F_SPLITTERS) {\n              const float4 v"),
            ("            for (int i = sid; i < 2 * KH / 16; i += F_SPLITTERS) {\n              const int d",
             "            for (int i = sid; i < 0; i += F_SPLITTERS) {\n              const int d")]
FLASH_VARIANTS = {"as built": ([], None), "integer rounding": ([], INT_RNA), "K, V not split": (SPLIT_KV, None)}
# (M, K, N, mode, LayerNorm prologue, calls per batch-8 i2v fp32 forward): the
# heaviest GEMM shapes of the forward (chip_smoke.py phase 10's table)
GEMM_SHAPES = [(327680, 320, 2560, cuda_lib.MODE_GEGLU, True, 5), (81920, 2560, 640, cuda_lib.MODE_RESIDUAL, False, 10),
               (20480, 5120, 1280, cuda_lib.MODE_RESIDUAL, False, 10),
               (327680, 320, 320, cuda_lib.MODE_RESIDUAL, False, 15),
               (20480, 1280, 3840, cuda_lib.MODE_STORE, True, 15), (9856, 1024, 2560, cuda_lib.MODE_STORE, False, 6)]
# (B, Nq, key segments): K2's self-attention at 40x64 and K3's i2v cross-attention
FLASH_SHAPES = [(128, 2560, (2560,)), (128, 640, (640,)), (128, 2560, (77, 16))]


def _fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _variant_sources(src_name, variants):
    src = (cuda_lib.CSRC / src_name).read_text()
    out = {}
    for name, (patches, rna) in variants.items():
        text = src
        for old, new in patches:
            if old not in text:
                _fail(f"{src_name} variant {name!r}: the source no longer has {old[:60]!r}")
            text = text.replace(old, new)
        hop = HOPPER.replace(_rna_body(HOPPER), rna) if rna else HOPPER
        out[name] = (text, hop)
    return out


def _build_all(jobs):
    """jobs: {key: (source text, hopper.cuh text, entry point)} -> loaded libraries, nvcc all at once."""
    procs = {}
    for key, (text, hop, _) in jobs.items():
        d = OUT / key.replace(" ", "_").replace(",", "").replace(".", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text)
        (d / "hopper.cuh").write_text(hop)
        procs[key] = (d, subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-I", str(d),
                                           "-o", str(d / "k.so"), str(d / "k.cu")],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (d, p) in procs.items():
        out, err = p.communicate()
        if p.returncode:
            _fail(f"variant {key} does not build:\n{out}\n{err[-3000:]}")
        lib = ctypes.CDLL(str(d / "k.so"))
        fn = getattr(lib, jobs[key][2])
        fn.argtypes = list(cuda_lib._SIGNATURES[jobs[key][2]])
        fn.restype = ctypes.c_int
        libs[key] = lib
    return libs


def _time_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _turns(names, run):
    """Each variant timed twice: in order, then in reverse order."""
    ms = {n: [] for n in names}
    for n in list(names) + list(reversed(names)):
        ms[n].append(run(n))
    return {n: sum(v) / len(v) for n, v in ms.items()}


def _errors(got, ref, ref64):
    top = float(ref.abs().max())
    err = {"vs_plain": float((got - ref).abs().max()) / top}
    if ref64 is not None:
        err["vs_fp64"] = float((got.double() - ref64).abs().max() / ref64.abs().max())
    return err


def main():
    if not torch.cuda.is_available():
        _fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    jobs = {f"gemm {n}": (*v, "ds_ln_gemm_f32") for n, v in _variant_sources("gemm_f32.cu", GEMM_VARIANTS).items()}
    jobs.update({f"flash {n}": (*v, "ds_flash_attention_f32")
                 for n, v in _variant_sources("attention_f32.cu", FLASH_VARIANTS).items()})
    cuda_lib.library()
    libs = _build_all(jobs)
    real = cuda_lib._lib
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    report = {"device": smi, "gemm": [], "flash": []}
    for M, K, N, mode, ln, calls in GEMM_SHAPES:
        x, w = rn(M, K), rn(N, K, s=K ** -0.5)
        kw = dict(mode=mode, bias=rn(N, s=0.1))
        if ln:
            kw["ln"] = (1.0 + rn(K, s=0.1), rn(K, s=0.1))
        if mode == cuda_lib.MODE_RESIDUAL:
            kw["residual"] = rn(M, N)
        ref = cuda_lib.ln_gemm_plain(x, w, **kw)
        ref64 = None
        if not ln and mode != cuda_lib.MODE_GEGLU:
            ref64 = x.double() @ w.double().t() + kw["bias"].double()
            if mode == cuda_lib.MODE_RESIDUAL:
                ref64 += kw["residual"].double()
        names = list(GEMM_VARIANTS)

        def call(n):
            cuda_lib._lib = libs[f"gemm {n}"]
            if n not in RAW_W:
                return cuda_lib.ln_gemm(x, w, **kw)
            # ln_gemm's call with the raw weights
            y = torch.empty((M, N // 2 if mode == cuda_lib.MODE_GEGLU else N), device="cuda")
            scratch = torch.empty_like(x) if ln else None
            tile = cuda_lib.gemm_f32_tile(M, K, N, mode)
            p, lnw = cuda_lib.ptr, kw.get("ln") or (None, None)
            cuda_lib.call("ds_ln_gemm_f32", p(x), M, K, p(lnw[0]), p(lnw[1]), 1e-5, None, None, 0, 0, 0, p(w), N,
                          p(kw["bias"]), p(kw.get("residual")), p(y), mode, p(scratch), tile.block_n, tile.stages)
            return y
        errs = {}
        for n in names:
            errs[n] = _errors(call(n), ref, ref64)
        ms = _turns(names, lambda n: _time_ms(lambda: call(n)))
        cuda_lib._lib = real
        lib_ms = _time_ms(lambda: F.linear(x, w))
        row = {"M": M, "K": K, "N": N, "mode": mode, "ln": ln, "calls": calls, "F.linear_ms": lib_ms,
               "ms": ms, "err": errs}
        report["gemm"].append(row)
        print(f"gemm M={M} K={K} N={N} mode {mode}{' LN' if ln else ''} x{calls}: F.linear {lib_ms:.3f} ms; "
              + "; ".join(f"{n} {ms[n]:.3f} ms (err {errs[n]['vs_plain']:.1e}"
                          + (f", vs fp64 {errs[n]['vs_fp64']:.1e}" if "vs_fp64" in errs[n] else "")
                          + (", wrong by design" if n in WRONG else "") + ")" for n in names), flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32:
            _fail(f"ds_ln_gemm_f32 as built misses the fp32 gate at M={M} K={K} N={N}")
        del x, w, kw, ref, ref64
    for B, Nq, lens in FLASH_SHAPES:
        C, heads = 320, 5
        q = rn(B, Nq, 3 * C)[..., :C]
        segs = []
        for L in lens:
            kv = rn(B, L, 2 * C)
            segs += [kv[..., :C], kv[..., C:]]
        with cuda_lib.plain_kernels():
            ref = fused_spatial.flash_attention(q, *segs, heads=heads, scale=0.125)
        names = list(FLASH_VARIANTS)

        def fcall(n):
            cuda_lib._lib = libs[f"flash {n}"]
            return fused_spatial.flash_attention(q, *segs, heads=heads, scale=0.125)
        errs = {n: _errors(fcall(n), ref, None) for n in names}
        ms = _turns(names, lambda n: _time_ms(lambda: fcall(n)))
        cuda_lib._lib = real
        report["flash"].append({"B": B, "Nq": Nq, "keys": list(lens), "ms": ms, "err": errs})
        print(f"flash B={B} Nq={Nq} keys {'+'.join(map(str, lens))}: "
              + "; ".join(f"{n} {ms[n]:.3f} ms (err {errs[n]['vs_plain']:.1e}"
                          + (", wrong by design" if n in WRONG else "") + ")" for n in names), flush=True)
        if errs["as built"]["vs_plain"] > TOL_F32:
            _fail(f"ds_flash_attention_f32 as built misses the fp32 gate at B={B} Nq={Nq} keys {lens}")
        del q, segs, ref
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
