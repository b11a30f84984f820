"""The arithmetic of the fp32 kernels' three-product tf32 split, on the CPU.

``csrc/gemm_f32.cu::ds_ln_gemm_f32`` and ``csrc/attention_f32.cu::
ds_flash_attention_f32`` multiply fp32 operands on the tensor cores, which
read only tf32 (10 mantissa bits): each operand is split as x = hi + lo,
hi = tf32(x), lo = tf32(x - hi) (``cvt.rna.tf32.f32``, ``hopper.cuh::
split_tf32``), a product runs as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, and the
products of each 32-deep step are added to the tile's accumulator in fp32.
``cuda_lib.tf32_rna``, ``split_tf32`` and ``matmul_3xtf32`` are plain models
of that arithmetic (the kernels never call them). Here:

* hi is a tf32 value (its 13 low mantissa bits zero) and hi + lo gives x
  back within 2^-22 of |x|;
* at every GEMM shape of K1-K8 in the full-width batch-8 i2v forward (K and
  N as the forward has them, M cut to 256; inputs N(0, 1), weights
  N(0, 1 / K), seeded numpy) the model's largest error stays within a tenth
  of ``chip_smoke.TOL_F32`` (1e-5, the per-kernel gate on the card) of the
  largest |exact| (float64) value, and its L2 error within a tenth of
  TOL_F32 of the exact product's norm;
* a single tf32 product (a_hi.b_hi) misses that gate, so the gate tells a
  one-product kernel from the split;
* P V with P in [0, 1] (softmax probabilities, 64 to 2560 keys) against
  V N(0, 1) holds the same gate;
* K1's attention at fp32 (``csrc/attention_f32.cu::
  ds_temporal_attention_f32``) modelled as the kernel computes it: at F 16
  and 8 the three-product attention on ``mma.sync`` with its key
  permutation, at F 4 and 32 the CUDA-core online softmax, within a tenth
  of the gate of ``temporal_attention_plain`` and, composed into K1, of the
  JAX K1 kernel in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from dynamicscaler_tpu_torch.ops import cuda_lib
from torch_port_helpers import i2v_transformers

TOL_F32 = 1e-5  # chip_smoke.TOL_F32: each fp32 kernel within 1e-5 of max|plain|, L2 within 1e-5
MARGIN = 10.0


def _errors(got, exact):
    """(largest error / largest |exact|, L2 error / L2 norm) against float64."""
    d = got.double() - exact
    return float(d.abs().max() / exact.abs().max()), float(d.norm() / exact.norm())


def test_hi_is_tf32_and_hi_plus_lo_is_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(np.concatenate([rng.standard_normal(100_000), rng.standard_normal(1000) * 1e-30,
                                         rng.standard_normal(1000) * 1e30, [0.0, 1.0, -1.0, 2.0 ** -126]])
                         .astype(np.float32))
    hi, lo = cuda_lib.split_tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    back = hi.double() + lo.double()
    assert bool(((back - x.double()).abs() <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0 ** -11 * x.abs()).all())  # to nearest: within half a tf32 ulp


def test_tf32_rounds_to_nearest_ties_away():
    """The tie 1 + 2^-11 (half a tf32 ulp above 1) rounds away from zero to
    1 + 2^-10, as ``cvt.rna`` does; just below it rounds down."""
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, -(one + 2.0 ** -11), one + 2.0 ** -11 - 2.0 ** -23, one + 2.0 ** -12],
                     dtype=torch.float32)
    got = cuda_lib.tf32_rna(x).tolist()
    assert got == [one + 2.0 ** -10, -(one + 2.0 ** -10), one, one]


def _gemm_shapes():
    """(K, N) of every GEMM of K1-K8 in the full-width batch-8 i2v forward."""
    shapes = set()
    for side, c, inner, _, _, _ in i2v_transformers():
        shapes |= {(c, inner), (inner, 3 * inner), (inner, inner), (inner, 8 * inner), (4 * inner, inner),
                   (inner, c)}
        if side == "s":
            shapes.add((1024, 2 * inner))
    return sorted(shapes)


GEMM_SHAPES = _gemm_shapes()


def _operands(K, N, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((256, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32))
    return a, b


@pytest.mark.parametrize("K,N", GEMM_SHAPES)
def test_3xtf32_holds_the_fp32_gate_at_every_forward_gemm(K, N):
    a, b = _operands(K, N, K * 100_003 + N)
    exact = a.double() @ b.double()
    err, l2 = _errors(cuda_lib.matmul_3xtf32(a, b), exact)
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (K, N, err, l2)


@pytest.mark.parametrize("K,N", [GEMM_SHAPES[0], GEMM_SHAPES[len(GEMM_SHAPES) // 2], GEMM_SHAPES[-1]])
def test_one_tf32_product_misses_the_gate(K, N):
    a, b = _operands(K, N, K * 100_003 + N)
    exact = a.double() @ b.double()
    err, l2 = _errors(cuda_lib.matmul_3xtf32(a, b, terms=1), exact)
    assert err > TOL_F32 and l2 > TOL_F32, (K, N, err, l2)


@pytest.mark.parametrize("keys", [64, 93, 640, 2560])
def test_3xtf32_pv_holds_the_gate(keys):
    """O = P V as the flash kernel forms it (P from the softmax, in [0, 1],
    V N(0, 1), head dim 64); the one-product P V misses the gate."""
    rng = np.random.default_rng(keys)
    logits = rng.standard_normal((256, keys)) * 2.0
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    P = torch.from_numpy(p.astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((keys, 64)).astype(np.float32))
    exact = P.double() @ V.double()
    err, l2 = _errors(cuda_lib.matmul_3xtf32(P, V, bk=64), exact)
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (keys, err, l2)
    err1, l21 = _errors(cuda_lib.matmul_3xtf32(P, V, terms=1, bk=64), exact)
    assert err1 > TOL_F32 and l21 > TOL_F32, (keys, err1, l21)


def _rz32(x):
    """float64 -> fp32 rounded towards zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core(a, b, k0, k1, acc):
    """The tensor core's products over k0..k1 into fp32 ``acc``: per k8 step
    the three split products, each added to the accumulator exactly and
    rounded towards zero."""
    (ah, al), (bh, bl) = cuda_lib.split_tf32(a), cuda_lib.split_tf32(b)
    ah, al, bh, bl = (t.double().numpy() for t in (ah, al, bh, bl))
    for k in range(k0, k1, 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _rz32(acc.astype(np.float64) + x[:, s] @ y[s])
    return acc


@pytest.mark.parametrize("K", [1280, 5120])
def test_accumulating_towards_zero_needs_the_per_stage_fold(K):
    """Why ds_ln_gemm_f32 adds each 32-deep stage's products to the tile's
    accumulator in fp32: the tensor core rounds its additions towards zero,
    a bias that grows with K. Modelled so, one accumulator over the whole K
    misses the gate at the UNet's K of 1280 and 5120, while a fresh
    accumulator a stage, folded in fp32, holds it with the 10x margin."""
    a, b = _operands(K, 128, K)
    a = a[:128]
    exact = (a.double() @ b.double()).numpy()
    single = _tensor_core(a, b, 0, K, np.zeros((128, 128), np.float32))
    folded = np.zeros((128, 128), np.float32)
    for k0 in range(0, K, cuda_lib.GEMM_F32_BK):
        folded = folded + _tensor_core(a, b, k0, k0 + cuda_lib.GEMM_F32_BK, np.zeros((128, 128), np.float32))
    top = np.abs(exact).max()
    assert np.abs(single - exact).max() / top > TOL_F32
    assert np.abs(folded - exact).max() / top <= TOL_F32 / MARGIN


# ---------------------------------------------------------------------------
# kernels 10 and 12 at fp32 (csrc/temporal_f32.cu), modelled phase by phase
# ---------------------------------------------------------------------------


def _mm_fold(a, w):
    """a [M, K] @ w [N, K]^T as ds_temporal_block_f32 multiplies: both split,
    the three products of each two 32-deep stages (64 k) into an accumulator
    of their own, folded into the tile's in fp32 (the sums inside an
    accumulator exact, as ``matmul_3xtf32`` models them)."""
    return cuda_lib.matmul_3xtf32(a, w.t().contiguous(), bk=64)


def _mm_tensor_core(a, w, bk=64):
    """:func:`_mm_fold` with each addition inside an accumulator rounded
    towards zero, as the tensor core rounds it (:func:`_tensor_core`)."""
    b = w.t().contiguous()
    acc = np.zeros((a.shape[0], w.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], bk):
        acc = acc + _tensor_core(a[:, k0:k0 + bk], b[k0:k0 + bk], 0, min(bk, a.shape[1] - k0), np.zeros_like(acc))
    return torch.from_numpy(acc)


def _mm_one_acc(a, w):
    """The same products into one accumulator over the whole K, each
    addition rounded towards zero as the tensor core rounds them."""
    acc = _tensor_core(a, w.t().contiguous(), 0, a.shape[1], np.zeros((a.shape[0], w.shape[0]), np.float32))
    return torch.from_numpy(acc)


def _ln_rows(x, s, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * s) + b


def _attention_rows(q, k, v, F, heads, scale):
    """The kernel's F-frame attention over token rows [T, C] (T / F rows of F
    frames): each logit computed once and scaled, the row's maximum, expf of
    each logit against it, their sum, then the weighted values over it."""
    T, C = q.shape

    def split(t):
        return t.reshape(T // F, F, heads, C // heads).transpose(1, 2)
    s = torch.matmul(split(q), split(k).transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p, split(v)) / p.sum(-1, keepdim=True)
    return o.transpose(1, 2).reshape(T, C)


def _block_model(x, lns, attn1, attn2, ff, F, heads, scale, mm=_mm_fold, mm_attn_out=None):
    """Kernel 10's phases over token rows x [T, C], in the kernel's order:
    LayerNorm into the rows the products read (their split is the A
    fragments' split in registers, as split_tf32 models it), q|k|v, the
    attention, the out-projection + bias + residual, twice; then w1 with the
    GEGLU epilogue, and w2 over the whole hidden (K 4C) + bias + residual.
    ``mm``: the products; ``mm_attn_out``: the out-projections' (the
    one-accumulator variant swaps it)."""
    mm_attn_out = mm_attn_out or mm
    s1, b1, s2, b2, s3, b3 = lns
    for (s, b), (wq, wk, wv, wo, bo) in (((s1, b1), attn1), ((s2, b2), attn2)):
        h = _ln_rows(x, s, b)
        q, k, v = (mm(h, w) for w in (wq, wk, wv))
        x = (mm_attn_out(_attention_rows(q, k, v, F, heads, scale), wo) + bo) + x
    w1, bb1, w2, bb2 = ff
    a = mm(_ln_rows(x, s3, b3), w1) + bb1
    val, gate = a.chunk(2, dim=-1)
    hidden = val * torch.nn.functional.gelu(gate, approximate="none")
    return (mm(hidden, w2) + bb2) + x


def _block_weights(rng, C):
    def w(n_out, n_in):
        return torch.from_numpy((rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)).astype(np.float32))

    def vec(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.standard_normal(n)).astype(np.float32))
    lns = tuple(vec(C, base) for _ in range(3) for base in (1.0, 0.0))
    attn = [(w(C, C), w(C, C), w(C, C), w(C, C), vec(C)) for _ in range(2)]
    return lns, attn[0], attn[1], (w(8 * C, C), vec(8 * C), w(C, 4 * C), vec(C)), w, vec


def _block_errors(got, ref, base):
    """(largest error / max|plain|, L2 error / L2 of the block's own output)."""
    return float((got - ref).abs().max() / ref.abs().max()), float((got - ref).norm() / (ref - base).norm())


def _k12_model_errors(mm):
    """Kernel 12's model at the t320 transformer's shape (C 320, 5 heads, F
    16), 128 tokens (x5 [1, 16, 2, 4, 320]) with products ``mm``, against
    the fp32 plain version: (largest error / max|plain|, L2 error / L2 of
    the transformer's own output)."""
    from dynamicscaler_tpu_torch.ops import fused_mega
    rng = np.random.default_rng(320)
    C, F, heads = 320, 16, 5
    lns, a1, a2, ff, w, vec = _block_weights(rng, C)
    w_in, b_in, w_out, b_out = w(C, C), vec(C), w(C, C), vec(C)
    x5 = torch.from_numpy(rng.standard_normal((1, F, 2, 4, C)).astype(np.float32))
    mul, add = vec(C, 1.0)[None], vec(C)[None]
    ref = fused_mega.temporal_mega_plain(x5, mul, add, w_in, b_in, lns, a1, a2, ff, w_out, b_out, heads=heads,
                                         scale=64 ** -0.5)
    rows = x5.permute(0, 2, 3, 1, 4).reshape(-1, C)  # F-frame rows (b, h, w), frame f
    h = mm(rows * mul + add, w_in) + b_in
    h = _block_model(h, lns, a1, a2, ff, F, heads, 64 ** -0.5, mm=mm)
    y = (mm(h, w_out) + b_out) + rows
    return _block_errors(y.reshape(1, 2, 4, F, C).permute(0, 3, 1, 2, 4), ref, x5)


def test_k12_model_with_the_tensor_cores_rounding_holds_the_gate():
    """Kernel 12's model at t320 with the tensor core's rounding towards zero
    inside each 64-k accumulator (:func:`_mm_tensor_core`): within the 1e-5
    gate with a margin of 5 (the card measured 1.5e-6 of max|plain| for the
    kernel, chip_tf32_variants.py), a margin the model of exact sums
    overstates."""
    err, l2 = _k12_model_errors(_mm_tensor_core)
    assert err <= TOL_F32 / 5 and l2 <= TOL_F32 / 5, (err, l2)


def test_k12_model_at_t320_holds_a_tenth_of_the_gate():
    """Kernel 12 at the t320 transformer's shape (C 320, 5 heads, F 16), 128
    tokens (x5 [1, 16, 2, 4, 320]): the GroupNorm apply, w_in, kernel 10's
    phases, w_out and the residual x5, each product as the kernel splits it
    and folds it (64 k at a time, :func:`_mm_fold`), against the fp32 plain
    version within a tenth of the 1e-5 gate."""
    err, l2 = _k12_model_errors(_mm_fold)
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (err, l2)


def test_k10_model_at_t1280_holds_a_tenth_of_the_gate_and_one_accumulator_does_not():
    """Kernel 10 at the t1280 block's shape (C 1280, 20 heads, F 16), 64
    tokens, against the fp32 plain version: within a tenth of the 1e-5 gate
    with each two 32-deep stages (64 k) folded in fp32 (:func:`_mm_fold`);
    with the out-projections (K 1280) in one accumulator rounding towards
    zero, outside the gate: why the fold stays."""
    from dynamicscaler_tpu_torch.ops import fused_block
    rng = np.random.default_rng(1280)
    C, F, heads = 1280, 16, 20
    lns, a1, a2, ff, _, _ = _block_weights(rng, C)
    x = torch.from_numpy(rng.standard_normal((4, F, C)).astype(np.float32))
    ref = fused_block.temporal_block_plain(x, lns, a1, a2, ff, heads=heads, scale=64 ** -0.5)
    got = _block_model(x.reshape(-1, C), lns, a1, a2, ff, F, heads, 64 ** -0.5).reshape(x.shape)
    err, l2 = _block_errors(got, ref, x)
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (err, l2)
    one = _block_model(x.reshape(-1, C), lns, a1, a2, ff, F, heads, 64 ** -0.5, mm_attn_out=_mm_one_acc)
    err1, l21 = _block_errors(one.reshape(x.shape), ref, x)
    assert err1 > TOL_F32 or l21 > TOL_F32, (err1, l21)


# ---------------------------------------------------------------------------
# kernel 11 at fp32 (csrc/spatial_f32.cu): the N-token attention on the tensor cores
# ---------------------------------------------------------------------------


def _exact_core(a, b, k0, k1, acc):
    """:func:`_tensor_core` with the sums inside the accumulator exact (float64),
    rounded to fp32 once at the end, as ``matmul_3xtf32`` models a stage."""
    (ah, al), (bh, bl) = cuda_lib.split_tf32(a), cuda_lib.split_tf32(b)
    ah, al, bh, bl = (t.double().numpy()[..., :] for t in (ah, al, bh, bl))
    s = slice(k0, k1)
    return (acc.astype(np.float64) + ah[:, s] @ bh[s] + ah[:, s] @ bl[s] + al[:, s] @ bh[s]).astype(np.float32)


def _tc_attention(q, k, v, scale, fold=True, core=_tensor_core):
    """One head's attention as ds_spatial_block_f32 forms it on the tensor
    cores: q [M, 64] over the keys k, v [L, 64] in tiles of 64; per tile S =
    Q K^T (8 k8 steps x 3 products into a fresh accumulator, ``core``: each
    addition rounded towards zero as the tensor core rounds it, or exact),
    scaled, the running maximum, alpha = exp(m_old - m), P = exp(S - m), l =
    l alpha + sum P; O_tile = P V into a fresh accumulator folded as O = O
    alpha + O_tile in fp32. ``fold`` False: P V into O's accumulator itself
    (O alpha as its start) across every key tile. Returns O / l."""
    M, L = q.shape[0], k.shape[0]
    m = np.full((M, 1), -np.inf, np.float32)
    l = np.zeros((M, 1), np.float32)
    o = np.zeros((M, 64), np.float32)
    for k0 in range(0, L, 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        n = kt.shape[0]
        s = core(q, kt.t().contiguous(), 0, 64, np.zeros((M, n), np.float32)) * np.float32(scale)
        mx = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp(m - mx).astype(np.float32)
        p = np.exp(s - mx).astype(np.float32)
        m = mx
        l = l * alpha + p.sum(axis=1, keepdims=True, dtype=np.float32)
        if fold:
            o = o * alpha + core(torch.from_numpy(p), vt, 0, n, np.zeros((M, 64), np.float32))
        else:
            o = core(torch.from_numpy(p), vt, 0, n, o * alpha)
    return torch.from_numpy(o / l)


@functools.lru_cache(maxsize=None)
def _k11_heads(rz):
    """Kernel 11's inputs at the s320 block's shape (C 320, 5 heads, N 2560,
    i2v: 77 text and 16 image keys), the fp32 plain version of the whole
    sample, and the heads as ds_ln_gemm_f32 multiplies them (a fold every
    32-deep stage; ``rz`` as in :func:`_k11_model_errors`): q of the first
    128 tokens, k and v of all 2560, the context's K and V per segment."""
    from dynamicscaler_tpu_torch.ops import fused_block
    rng = np.random.default_rng(2560)
    C, N, heads, Dc, Lt, Li, M = 320, 2560, 5, 1024, 77, 16, 128
    lns, a1, _, ff, w, vec = _block_weights(rng, C)
    a2 = (w(C, C), w(C, Dc), w(C, Dc), w(C, C), vec(C), w(C, Dc), w(C, Dc))
    x = torch.from_numpy(rng.standard_normal((1, N, C)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, Lt + Li, Dc)).astype(np.float32))
    ref = fused_block.spatial_block_plain(x, ctx, lns, a1, a2, ff, heads=heads, scale=0.125, text_len=Lt)[0, :M]

    def head(a, wt):
        return _mm_tensor_core(a, wt, bk=32) if rz else cuda_lib.matmul_3xtf32(a, wt.t().contiguous())
    xs, (ct, ci) = x[0], (ctx[0, :Lt], ctx[0, Lt:])
    h1 = _ln_rows(xs, *lns[:2])
    wq, wk, wv, _, _ = a1
    _, wk2, wv2, _, _, wki, wvi = a2
    qkv = (head(h1[:M], wq), head(h1, wk), head(h1, wv))
    kvs = ((head(ct, wk2), head(ct, wv2)), (head(ci, wki), head(ci, wvi)))
    return xs[:M], lns, a1, a2, ff, ref, qkv, kvs


def _k11_model_errors(fold=True, rz=True):
    """Kernel 11's model at s320: the first 128 query tokens of a frame
    sample over all 2560 keys (:func:`_k11_heads`), the body's products
    folded every two stages, both attentions by :func:`_tc_attention`;
    ``rz``: every accumulator rounding towards zero as the tensor core's
    does (:func:`_mm_tensor_core`, :func:`_tensor_core`), else its sums
    exact (:func:`_mm_fold`, :func:`_exact_core`). Returns (largest error /
    max|plain|, L2 error / L2 of the block's own output)."""
    x, lns, a1, a2, ff, ref, (q, k, v), kvs = _k11_heads(rz)
    mm = _mm_tensor_core if rz else _mm_fold
    core = _tensor_core if rz else _exact_core

    def attend(q, kvs):
        return torch.cat([sum(_tc_attention(q[:, d:d + 64], kk[:, d:d + 64], vv[:, d:d + 64], 0.125, fold, core)
                              for kk, vv in kvs) for d in range(0, q.shape[1], 64)], dim=1)
    _, _, s2, b2, s3, b3 = lns
    wo, bo = a1[3:]
    wq2, _, _, wo2, bo2, _, _ = a2
    h = (mm(attend(q, [(k, v)]), wo) + bo) + x
    h = (mm(attend(mm(_ln_rows(h, s2, b2), wq2), kvs), wo2) + bo2) + h
    w1, bb1, w2, bb2 = ff
    val, gate = (mm(_ln_rows(h, s3, b3), w1) + bb1).chunk(2, dim=-1)
    y = (mm(val * torch.nn.functional.gelu(gate, approximate="none"), w2) + bb2) + h
    return _block_errors(y, ref, x)


def test_k11_model_at_s320_holds_a_tenth_of_the_gate():
    """Kernel 11 at s320 (128 queries over the sample's 2560 keys, i2v), each
    product split and folded as the kernel folds it (the body's every two
    stages, the N-token and cross-attention's P V per key tile after the
    online softmax), the sums inside an accumulator exact: within a tenth
    of the 1e-5 gate against the fp32 plain version."""
    err, l2 = _k11_model_errors(rz=False)
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (err, l2)


def test_k11_model_with_the_tensor_cores_rounding_holds_the_gate():
    """The same with every accumulator rounding towards zero as the tensor
    core's does: within the 1e-5 gate with a margin of 4 (the kernel 12
    model above does the same: the rounding inside a 64-k accumulator alone
    takes a model past a tenth). With P V accumulated across all 40 key tiles
    in O's accumulator instead (``fold=False``) the model gives the figure
    PERF.md records: printed (``-s``), not asserted."""
    err, l2 = _k11_model_errors()
    print(f"K11 s320 model with rounding towards zero: P V folded per key tile {err:.3g} / {l2:.3g}; "
          "in one accumulator %.3g / %.3g" % _k11_model_errors(fold=False))
    assert err <= TOL_F32 / 4 and l2 <= TOL_F32 / 4, (err, l2)


# ---------------------------------------------------------------------------
# K1's attention at fp32 (csrc/attention_f32.cu::ds_temporal_attention_f32)
# ---------------------------------------------------------------------------


def _fma32(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _ta_warp_tc(q, k, v, F, scale, core):
    """One warp's 16 tokens (a row of 16 frames, or two of 8) as
    ``ta_warp_tc`` computes them on the tensor cores: S in steps of 8 dims,
    each step's three products into a fresh accumulator (``core``) folded in
    fp32, the B operand's column g of key tile n holding key 8n + (g >> 1) +
    (g & 1) * 4; the logits scaled (at F 8 the other row's masked), the
    row's maximum, expf, the sum as the lane quad adds it; P's A fragment
    read from S's registers (column 2t -> A column t, 2t + 1 -> t + 4), P V
    in two steps of 8 keys, each folded; O times the sum's reciprocal."""
    f32 = np.float32
    perm = np.array([(g >> 1) + (g & 1) * 4 for g in range(8)])
    s = np.zeros((16, 16), f32)  # S's columns in the permuted order: column 8n + g is key 8n + perm[g]
    for n in range(2):
        kt = k[8 * n + perm]  # B [8 keys, 64 dims] as the lanes read it
        for kk in range(0, 64, 8):
            s[:, 8 * n:8 * n + 8] += core(q[:, kk:kk + 8], kt[:, kk:kk + 8].t().contiguous(), 0, 8,
                                          np.zeros((16, 8), f32))
    rows = np.arange(16)[:, None] // 8
    keys = 8 * (np.arange(16)[None, :] // 8) + np.tile(perm, 2)[None, :]
    own = (keys // 8 == rows) | (F == 16)
    s = np.where(own, s * f32(scale), f32(-np.inf))
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(f32)
    quad = np.zeros((16, 4), f32)  # lane t's sum of its four columns (2t, 2t + 1 of both key tiles), in order
    for t in range(4):
        for c in (2 * t, 2 * t + 1, 8 + 2 * t, 8 + 2 * t + 1):
            quad[:, t] += p[:, c]
    pair = quad + quad[:, [1, 0, 3, 2]]
    l = pair + pair[:, [2, 3, 0, 1]]
    a = np.zeros((16, 16), f32)  # P by key: A column c of key step n is key 8n + c
    for n in range(2):
        for t in range(4):
            a[:, 8 * n + t] = p[:, 8 * n + 2 * t]
            a[:, 8 * n + t + 4] = p[:, 8 * n + 2 * t + 1]
    o = np.zeros((16, 64), f32)
    for n in range(2):
        o += core(torch.from_numpy(a[:, 8 * n:8 * n + 8]), v[8 * n:8 * n + 8], 0, 8, np.zeros((16, 64), f32))
    return o * (f32(1.0) / l[:, :1])


def _ta_token_cc(q, k, v, F, scale):
    """The CUDA-core path (``ta_token_cc``) over tokens [T, 64] of rows of F:
    two threads a token, each a half's partial logit in four fma chains
    added as (p0 + p1) + (p2 + p3), the halves added and scaled; an online
    softmax over the row's keys in order (the sum and the weighted values
    rescaled by expf(m_old - m) where the maximum grows); O over the sum."""
    f32 = np.float32
    T = q.shape[0]
    qn, kn, vn = (t.numpy() for t in (q, k, v))
    base = (np.arange(T) // F) * F
    m = np.full(T, -np.inf, f32)
    l = np.zeros(T, f32)
    o = np.zeros((T, 64), f32)
    for j in range(F):
        kj, vj = kn[base + j], vn[base + j]
        halves = []
        for h in range(2):
            p4 = np.zeros((T, 4), f32)
            for d in range(32 * h, 32 * h + 32, 4):
                p4 = _fma32(qn[:, d:d + 4], kj[:, d:d + 4], p4)
            halves.append((p4[:, 0] + p4[:, 1]) + (p4[:, 2] + p4[:, 3]))
        s = (halves[0] + halves[1]) * f32(scale)
        grow = s > m
        alpha = np.exp(np.where(grow, m - s, f32(0.0))).astype(f32)
        l = np.where(grow, l * alpha, l)
        o = np.where(grow[:, None], o * alpha[:, None], o)
        m = np.where(grow, s, m)
        p = np.exp(s - m).astype(f32)
        l = l + p
        o = _fma32(p[:, None], vj, o)
    return o * (f32(1.0) / l)[:, None]


def _ta_model(qkv, F, heads, scale, core):
    """ds_temporal_attention_f32's model over qkv [T, 3C]: per head, at F 8
    and 16 warps of 16 tokens on the tensor cores, else the CUDA-core path."""
    T, C3 = qkv.shape
    C = C3 // 3
    out = np.zeros((T, C), np.float32)
    for h in range(heads):
        q, k, v = (qkv[:, i * C + 64 * h:i * C + 64 * h + 64].contiguous() for i in range(3))
        if F in (8, 16):
            for r0 in range(0, T, 16):
                out[r0:r0 + 16, 64 * h:64 * h + 64] = _ta_warp_tc(q[r0:r0 + 16], k[r0:r0 + 16], v[r0:r0 + 16], F,
                                                                   scale, core)
        else:
            out[:, 64 * h:64 * h + 64] = _ta_token_cc(q, k, v, F, scale)
    return torch.from_numpy(out)


@pytest.mark.parametrize("core", ["exact", "towards zero"])
@pytest.mark.parametrize("R,F,heads", [(16, 16, 2), (24, 8, 2), (32, 4, 1), (4, 32, 2)])
def test_temporal_attention_f32_model_holds_a_tenth_of_the_gate(R, F, heads, core):
    """TA.f32's model (F 16 and 8: the three-product tf32 attention with the
    key permutation; F 4 and 32: the CUDA-core online softmax) against the
    fp32 plain version ``temporal_attention_plain``, whose K1 the JAX K1
    kernel holds below, within a tenth of the 1e-5 gate (max error and L2);
    the tensor core's additions exact or rounded towards zero. The same
    bits on a repeat."""
    from dynamicscaler_tpu_torch.ops import fused_temporal
    rng = np.random.default_rng(R * F)
    C = 64 * heads
    qkv = torch.from_numpy((rng.standard_normal((R * F, 3 * C)) * 1.5).astype(np.float32))
    ref = fused_temporal.temporal_attention_plain(qkv.reshape(R, F, 3 * C), heads=heads, scale=0.125).reshape(-1, C)
    cf = _exact_core if core == "exact" else _tensor_core
    got = _ta_model(qkv, F, heads, 0.125, cf)
    err, l2 = _errors(got, ref.double())
    assert err <= TOL_F32 / MARGIN and l2 <= TOL_F32 / MARGIN, (err, l2)
    assert torch.equal(got, _ta_model(qkv, F, heads, 0.125, cf))


@pytest.mark.parametrize("R,F,C,heads", [(8, 16, 128, 2), (12, 8, 64, 1), (16, 4, 64, 1), (4, 32, 128, 2)])
def test_temporal_attention_f32_model_in_k1_matches_the_jax_kernel(R, F, C, heads):
    """K1 composed around TA.f32's model (the port's LayerNorm and fp32
    projections, the model's attention, the out-projection, bias and
    residual) against the JAX K1 kernel in interpret mode at fp32: the
    attention branch (output - x) within a tenth of the 1e-5 gate of its
    largest magnitude and of its L2 norm."""
    import jax.numpy as jnp

    from dynamicscaler_tpu.ops import fused_temporal as jtemporal
    from dynamicscaler_tpu_torch.models.layers import layer_norm
    rng = np.random.default_rng(F)
    f32 = np.float32
    x = (rng.standard_normal((R, F, C)) * 0.5).astype(f32)
    s = (1.0 + 0.1 * rng.standard_normal(C)).astype(f32)
    b = (0.1 * rng.standard_normal(C)).astype(f32)
    mats = [(rng.standard_normal((C, C)) / np.sqrt(C)).astype(f32) for _ in range(4)]
    bo = (0.1 * rng.standard_normal(C)).astype(f32)
    scale = 0.125
    jtemporal.set_mode("interpret")
    try:
        ref = np.asarray(jtemporal.fused_ln_attention(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                                      *map(jnp.asarray, mats), jnp.asarray(bo), heads=heads,
                                                      scale=scale))
    finally:
        jtemporal.set_mode("auto")
    xt = torch.from_numpy(x).reshape(R * F, C)
    h = layer_norm(xt, torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    wq, wk, wv, wo = (torch.from_numpy(m) for m in mats)  # flax [in, out]
    qkv = torch.cat([h @ wq, h @ wk, h @ wv], dim=1)
    o = _ta_model(qkv, F, heads, scale, _tensor_core)
    got = ((o @ wo + torch.from_numpy(bo)) + xt).reshape(R, F, C).numpy()
    branch = ref - x
    d = got - ref
    assert np.abs(d).max() <= TOL_F32 / MARGIN * np.abs(branch).max(), np.abs(d).max() / np.abs(branch).max()
    assert np.linalg.norm(d) <= TOL_F32 / MARGIN * np.linalg.norm(branch)
