"""Build, load and call the hand-written CUDA kernels in ``csrc/``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The build happens at first use, into
``build/kernels-<hash>/`` at the repository root, keyed by a hash of the
sources and flags; importing this module builds nothing.

Each op wrapper in ``ops/fused_*.py`` takes its plain PyTorch version for a
CPU tensor and launches its kernel for a CUDA tensor. :func:`plain_kernels`
is the one explicit way to run the plain versions on the card (for the
kernel-vs-plain comparisons of ``chip_smoke.py``). :func:`ln_gemm` binds
the GEMM that every op's projections run on (K1-K4 and the transformer
wrapper head and tail); :class:`PackCache` keeps a module's kernel operands
packed between calls; the whole-block and whole-transformer kernels (10-13)
take their operands as one array of pointers (:func:`ptr_array`), their
tile plan (:func:`block_plan` for kernels 10 and 12, :func:`spatial_plan`
for 11 and 13) and the TMA maps of their weights (:func:`block_maps`,
:func:`spatial_maps`, encoded once per weight set); :func:`gn_plan` picks
the route of kernel 9's one call, GroupNorm [+ SiLU] with its statistics.

Activations are bf16 or fp32. An fp32 activation takes the fp32 kernels
wherever a bf16 one takes the bf16 kernels: ``gemm_f32.cu::ds_ln_gemm_f32``
(its tile from :func:`gemm_f32_tile`, its weights split once each by
:func:`tf32_split_weights`), ``attention_f32.cu``'s two attention cores (the
GEMM and the flash attention multiply on the tensor cores through a
three-product tf32 split, :func:`matmul_3xtf32` its plain model for the
tests), ``gn_silu.cu``'s kernels
instantiated at fp32 (K1-K9 and the statistics), ``temporal_f32.cu``'s whole
temporal block and transformer (kernels 10 and 12 on the tensor cores
through the same split, their tile from :func:`block_f32_plan`, a slot of
scratch a block, :func:`temporal_f32_scratch`) and ``spatial_f32.cu``'s
spatial bodies (kernels 11 and 13 on the same block and products, with the
N-token and cross-attention on the tensor cores too; their query tile from
:func:`spatial_f32_plan`, their scratch :func:`spatial_f32_scratch`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parent.parent
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "ds_ln_gemm": (_P, _I, _I, _P, _P, _F, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P),
    "ds_ln_gemm_pingpong": (_P, _I, _I, _P, _P, _F, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P),
    "ds_ln_gemm_f32": (_P, _I, _I, _P, _P, _F, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P),
    "ds_tf32_split": (_P, _L, _P, _P),
    "ds_gn_silu": (_P, _I, _L, _I, _P, _P, _I, _P, _I, _P),
    "ds_gn_stats": (_P, _I, _I, _L, _I, _I, _I, _P, _P, _I, _F, _P, _P, _P, _P),
    "ds_group_norm_silu": (_P, _I, _L, _I, _I, _P, _P, _I, _F, _I, _I, _I, _L, _I, _I, _P, _P, _I, _P),
    "ds_gn_clusters": (_I, _I, _I, _P, _P),
    "ds_temporal_attention": (_P, _I, _I, _I, _I, _F, _P, _P),
    "ds_flash_attention": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _P, _I, _P),
    "ds_temporal_attention_f32": (_P, _I, _I, _I, _I, _F, _P, _P),
    "ds_flash_attention_f32": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _P, _I, _P),
    "ds_temporal_block": (_P, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _P),
    "ds_temporal_mega": (_P, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _I, _I, _P),
    "ds_block_maps": (_P, _I, _I, _I, _P, _P),
    "ds_block_clusters": (_I, _I, _I, _I, _P, _P),
    "ds_mega_spatial": (_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _P),
    "ds_spatial_block": (_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _I, _I, _I, _I, _P),
    "ds_spatial_maps": (_P, _I, _I, _P, _P),
    "ds_temporal_block_f32": (_P, _I, _I, _I, _F, _F, _P, _L, _I, _I, _P),
    "ds_temporal_mega_f32": (_P, _I, _I, _I, _I, _F, _F, _P, _L, _I, _I, _P),
    "ds_spatial_block_f32": (_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _L, _I, _I, _P),
    "ds_mega_spatial_f32": (_P, _I, _I, _I, _I, _I, _I, _F, _F, _P, _L, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
_plain = threading.local()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return cand


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into ``build/kernels-<hash>/libdscaler.so``
    (no-op when that file exists): one ``nvcc`` per source, all started
    together, then one link. Returns the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = REPO_ROOT / "build" / f"kernels-{h.hexdigest()[:16]}"
    lib = out_dir / "libdscaler.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *(["-Xptxas=-v"] if verbose else []), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, err = p.communicate()
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = out_dir / f"libdscaler.{tag}.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    for o in objs:
        o.unlink()
    if verbose and any(logs):
        print("".join(logs))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch ``name`` on the current stream; raise if the launch failed."""
    fn = getattr(library(), name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


@contextlib.contextmanager
def plain_kernels():
    """Run the ops' plain PyTorch versions on CUDA tensors inside this
    block (the reference side of kernel-vs-plain comparisons)."""
    prev = getattr(_plain, "on", False)
    _plain.on = True
    try:
        yield
    finally:
        _plain.on = prev


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the op must launch its kernel: the tensors are on a CUDA
    device and no :func:`plain_kernels` block is active. CPU tensors take
    the plain version; a mix of devices is an error."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return False
    if devs != {"cuda"}:
        raise ValueError(f"tensors on mixed devices: {sorted(devs)}")
    return not getattr(_plain, "on", False)


def check_operand(name: str, t: torch.Tensor, dtype=torch.bfloat16, shape=None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (and ``shape``); the kernels load 16 bytes per thread."""
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: kernel takes a contiguous 16-byte aligned CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device} contiguous={t.is_contiguous()} address={t.data_ptr():#x}"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


# the activation types of the kernels: each wrapper takes one for all its
# activations, weights, residuals and contexts, and picks its kernel by it
ACT_DTYPES = (torch.bfloat16, torch.float32)


def check_dtypes(name: str, *tensors) -> torch.dtype:
    """Raise ValueError unless every tensor given (None skipped) has one
    activation type of :data:`ACT_DTYPES`; return it. Checked on every
    device, before the wrapper picks its kernel or its plain version."""
    dts = {t.dtype for t in tensors if t is not None}
    if len(dts) != 1 or not dts <= set(ACT_DTYPES):
        raise ValueError(f"{name}: the kernels take bfloat16 or float32 activations, all of one type; got "
                         f"{sorted(str(d) for d in dts)}")
    return dts.pop()


_split_lock = threading.Lock()
_split_weights = {}  # (storage address, offset, shape, stride) -> (weak ref to the storage, version, [2, N, K])


def tf32_split_weights(w: torch.Tensor) -> torch.Tensor:
    """The fp32 weight ``w`` [N, K] on the card split for ``ds_ln_gemm_f32``:
    [2, N, K], W_hi = tf32(W) and W_lo = tf32(W - W_hi) (``ds_tf32_split``).
    Computed at a weight's first use and kept while its storage lives and
    is not changed in place (a view or ``detach()`` of the same weight finds
    the same entry, so callers that cast or reshape their weights on every
    call still split them once); twice the weight's bytes on the card. An
    inference tensor (the operands a module packs inside the forward's
    ``torch.inference_mode``) has no version counter: its entry holds while
    its storage lives."""
    from torch.multiprocessing.reductions import StorageWeakRef

    storage = w.untyped_storage()
    key = (storage.data_ptr(), w.storage_offset(), tuple(w.shape), w.stride())
    version = None if w.is_inference() else w._version
    with _split_lock:
        hit = _split_weights.get(key)
        if hit is not None and not hit[0].expired() and hit[1] == version:
            return hit[2]
        for k in [k for k, v in _split_weights.items() if v[0].expired()]:
            del _split_weights[k]
        out = torch.empty((2, *w.shape), device=w.device, dtype=torch.float32)
        call("ds_tf32_split", ptr(w), w.numel(), ptr(out))
        _split_weights[key] = (StorageWeakRef(storage), version, out)
        return out


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def ptr_array(tensors):
    """A host array of device pointers (null for None), for the kernels that
    take their many operands as one ``const void* const*``."""
    return (ctypes.c_void_p * len(tensors))(*(None if t is None else t.data_ptr() for t in tensors))


def f32(t: torch.Tensor) -> torch.Tensor:
    """A LayerNorm or bias vector as the kernels read it: contiguous fp32."""
    return t.detach().float().contiguous()


def act(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A weight as the kernels read it: contiguous, in the activation type."""
    return t.detach().to(dtype).contiguous()


class PackCache:
    """A module's kernel operands (fp32 vectors, weights cast to the
    activation type and concatenated), packed once and packed anew only when
    one of the module's parameters is replaced (``.to``, ``load_state_dict``
    with ``assign``) or changed in place (``load_state_dict``, ``copy_``).
    It holds the parameters it packed from, so their addresses are not
    reused while the key names them."""

    def __init__(self):
        self._key = None
        self._value = None
        self._held = ()

    def get(self, pack, params, dtype):
        live = [p for p in params if p is not None]
        key = (dtype, *((p.data_ptr(), p._version) for p in live))
        if key != self._key:
            self._value = pack()
            self._key, self._held = key, tuple(p.detach() for p in live)
        return self._value


MODE_STORE, MODE_RESIDUAL, MODE_GEGLU = 0, 1, 2

# ds_ln_gemm's tile (csrc/gemm.cu): 128 rows x BN columns a tile, K in steps
# of 64 through a ring of `stages` (A, B) tiles in shared memory; a persistent
# grid of one block per SM (132). Two schedules of its two consumer
# warpgroups: "cooperative" (64 rows of every tile each, BN 64, 128, 256 or
# 320, the last as two 160-column wgmma products, beside one bf16 staging
# tile of 128 rows of one product's columns + 8) and "pingpong" (whole 128 x
# BN tiles in turn, BN 128 or 160, each warpgroup's epilogue under the
# other's products; each warpgroup's bf16 output tile beside the ring, and
# two more mbarriers a warpgroup). The 160-column products make an N-320
# GEMM one cooperative column tile or two ping-pong ones with no padding (BN
# 128: three, the last half zeros), and 320 divides every transformer width.
GEMM_BM, GEMM_BK, GEMM_SMS = 128, 64, 132
GEMM_BLOCK_N = {"cooperative": (320, 256, 128, 64), "pingpong": (160, 128)}
GEMM_SMEM_MAX = 232448  # bytes of shared memory a block may have on the H100
GEMM_MAX_STAGES = 8
# the C entry point of each schedule
_GEMM_ENTRY = {"cooperative": "ds_ln_gemm", "pingpong": "ds_ln_gemm_pingpong"}
# A round of tiles over the SMs at each (schedule, BN): the products take
# K * per_k microseconds a tile and the epilogue per_tile[mode] (store,
# residual, GEGLU). A cooperative tile takes their sum: both warpgroups run
# the epilogue and no product is issued meanwhile. A ping-pong warpgroup's
# epilogue runs under the other's products, so two tiles take the larger of
# two products and one product plus one epilogue. Least squares (relative)
# on the H100's times of every GEMM shape of the batch-8 i2v forward at 40x64
# and of the DynamiCrafter forward at 72x128 at every (schedule, BN), the
# prologue pass taken off, over the shapes of 0.1 ms and more (below that a
# launch's time is the host's; chip_smoke.py phases 3 and 14 time the
# planner's pick beside the pick of the table before BN 320 and 160).
_GEMM_TILE_COST = {
    ("cooperative", 320): (0.01404, (6.03, 18.99, 7.758)),
    ("cooperative", 256): (0.01125, (4.889, 14.63, 5.897)),
    ("cooperative", 128): (0.00701, (2.403, 7.479, 3.266)),
    ("cooperative", 64): (0.005315, (1.289, 3.975, 1.673)),
    ("pingpong", 160): (0.009541, (6.915, 10.18, 10.44)),
    ("pingpong", 128): (0.008507, (6.26, 8.363, 7.576)),
}


class GemmTile(NamedTuple):
    block_n: int
    stages: int
    smem: int  # dynamic shared memory bytes, the 1024-byte alignment pad included
    schedule: str = "cooperative"


def gemm_smem(block_n: int, stages: int, schedule: str = "cooperative") -> int:
    """Shared memory of a ``ds_ln_gemm`` block, as ``csrc/gemm.cu`` reckons
    it: the ring and the alignment pad; cooperative: the epilogue's bf16
    staging tile (128 rows of one wgmma product's columns + 8: block_n, or
    half of it past 256) and two mbarriers a stage; ping-pong: each
    warpgroup's output tile (128 x block_n bf16) and two mbarriers a stage
    and two a warpgroup."""
    ring = stages * (GEMM_BM + block_n) * GEMM_BK * 2 + 1024
    if schedule == "pingpong":
        return ring + 2 * GEMM_BM * block_n * 2 + 8 * (2 * stages + 4)
    product_n = block_n // 2 if block_n > 256 else block_n
    return ring + GEMM_BM * (product_n + 8) * 2 + 16 * stages


# ds_ln_gemm_f32's tile (csrc/gemm_f32.cu): 128 rows x BN columns a tile, K in
# steps of 32 (one 128-byte swizzle row of fp32) through a ring of `stages`
# stages of A, W_hi and W_lo (tf32_split_weights), two mbarriers a stage;
# a persistent grid of one block per SM. BN is at most 128: a consumer thread
# holds the tile's accumulators and a stage's own, BN / 2 each.
GEMM_F32_BK = 32
GEMM_F32_BLOCK_N = (128, 64)
GEMM_F32_MAX_STAGES = 8
# relative time per output column of a tile at each BN: at 64 a consumer
# loads and splits its A values for half as many products, and the ring
# carries twice the A bytes per product (phase 10 of chip_smoke.py times
# every shape at the other width too)
_GEMM_F32_COLUMN_COST = {128: 1.0, 64: 1.5}


def gemm_f32_smem(block_n: int, stages: int) -> int:
    """Shared memory of a ``ds_ln_gemm_f32`` block, as ``csrc/gemm_f32.cu``
    reckons it: the alignment pad, the ring (A 128 x 32, B and its remainders
    block_n x 32 each, fp32) and two mbarriers a stage."""
    return 1024 + stages * (GEMM_BM + 2 * block_n) * GEMM_F32_BK * 4 + 16 * stages


def gemm_f32_tile(M: int, K: int, N: int, mode: int = MODE_STORE, block_n: int | None = None) -> GemmTile:
    """The tile of ``ds_ln_gemm_f32`` at [M, K] x [N, K]: the BN whose rounds
    of tiles over the 132 SMs take least time by :data:`_GEMM_F32_COLUMN_COST`
    (GEGLU pairs value and gate columns, so there BN / 2 must divide N / 2),
    then as many ring stages as K has steps and shared memory holds (at least
    2). ``block_n`` fixes BN (chip_smoke.py times the width not chosen)."""
    cands = [bn for bn in GEMM_F32_BLOCK_N if (block_n is None or bn == block_n)
             and (mode != MODE_GEGLU or (N // 2) % (bn // 2) == 0)]
    m_tiles = -(-M // GEMM_BM)

    def cost(bn):
        return -(-m_tiles * gemm_n_tiles(N, bn, mode) // GEMM_SMS) * bn * _GEMM_F32_COLUMN_COST[bn]
    bn = min(cands, key=cost)
    fit = max(s for s in range(2, GEMM_F32_MAX_STAGES + 1) if gemm_f32_smem(bn, s) <= GEMM_SMEM_MAX)
    stages = max(2, min(fit, -(-K // GEMM_F32_BK)))
    return GemmTile(bn, stages, gemm_f32_smem(bn, stages))


def gemm_n_tiles(N: int, block_n: int, mode: int = MODE_STORE) -> int:
    """Column tiles of a GEMM over W [N, K] at width block_n (in GEGLU a tile
    holds block_n / 2 value and as many gate columns)."""
    return N // block_n if mode == MODE_GEGLU else -(-N // block_n)


def gemm_grid(M: int, N: int, block_n: int, mode: int = MODE_STORE) -> int:
    """Blocks of a ``ds_ln_gemm`` / ``ds_ln_gemm_f32`` launch: one a tile, at
    most one a streaming multiprocessor (the grid is persistent)."""
    return min(-(-M // GEMM_BM) * gemm_n_tiles(N, block_n, mode), GEMM_SMS)


# ds_flash_attention_f32 (csrc/attention_f32.cu): tiles of 128 query rows of
# one (sample, head) on a persistent grid; key tiles of 64 through a ring of
# 2 slots, each the raw K (rounded in place) and its remainders, the raw V,
# and V^T rounded and its remainders ([64, 64] fp32 each); Q rounded in place
# and its remainders ([128, 64] fp32 each); two mbarriers for Q and three a slot
FLASH_F32_BQ, FLASH_F32_BK, FLASH_F32_SLOTS = 128, 64, 2


def flash_f32_smem() -> int:
    """Shared memory of a ``ds_flash_attention_f32`` block, as
    ``csrc/attention_f32.cu`` reckons it (the same at every N and segment
    layout: a segment is streamed in key tiles of 64)."""
    tile = FLASH_F32_BK * 64 * 4
    return 1024 + 2 * FLASH_F32_BQ * 64 * 4 + FLASH_F32_SLOTS * 5 * tile + 8 * (2 + 3 * FLASH_F32_SLOTS)


def flash_grid(B: int, Nq: int, heads: int) -> int:
    """Blocks of a ``ds_flash_attention_f32`` launch: one a tile of 128 query
    rows of one (sample, head), at most one a streaming multiprocessor."""
    return min(B * heads * -(-Nq // FLASH_F32_BQ), GEMM_SMS)


@functools.lru_cache(maxsize=None)
def gemm_tile(M: int, K: int, N: int, mode: int = MODE_STORE, schedule: str | None = None,
              block_n: int | None = None) -> GemmTile:
    """The tile of ``ds_ln_gemm`` at [M, K] x [N, K]: the schedule and BN
    whose rounds of tiles over the 132 SMs take least time by
    :data:`_GEMM_TILE_COST` (GEGLU pairs value and gate columns, so there BN /
    2 must divide N / 2), then as many ring stages as K has steps and shared
    memory holds (at least 2). ``schedule`` and ``block_n`` fix the schedule
    and the width (chip_smoke.py times the ones not chosen). Cached: every
    launch asks, and a forward has a few dozen shapes."""
    cands = [(sched, bn) for sched, widths in GEMM_BLOCK_N.items() if schedule in (None, sched) for bn in widths
             if block_n in (None, bn) and (mode != MODE_GEGLU or (N // 2) % (bn // 2) == 0)]
    if not cands:
        raise ValueError(f"gemm_tile: no {schedule or 'bf16'} tile of width {block_n} takes N={N} in mode {mode}")
    m_tiles = -(-M // GEMM_BM)

    def cost(c):
        per_k, per_tile = _GEMM_TILE_COST[c]
        products, epilogue = K * per_k, per_tile[mode]
        tile = max(products, (products + epilogue) / 2) if c[0] == "pingpong" else products + epilogue
        return -(-m_tiles * gemm_n_tiles(N, c[1], mode) // GEMM_SMS) * tile
    sched, bn = min(cands, key=cost)
    fit = max(s for s in range(2, GEMM_MAX_STAGES + 1) if gemm_smem(bn, s, sched) <= GEMM_SMEM_MAX)
    stages = max(2, min(fit, -(-K // GEMM_BK)))
    return GemmTile(bn, stages, gemm_smem(bn, stages, sched), sched)


# ds_temporal_block_f32 / ds_temporal_mega_f32's tile (csrc/temporal_f32.cu):
# a persistent grid of one 384-thread block an SM, each taking tiles of TM
# tokens (whole F-frame rows at every F the gate admits); every product on
# tf32 wgmma with the tokens as the M side, column tiles of 128 weight rows,
# a ring of 4 slots of 32-deep k stages (the TM token rows, the 128 weight
# rows split: W_hi, W_lo). chip_tf32_variants.py times the alternatives
# (clusters of 2 sharing each weight tile by multicast, the token rows split
# when written, the residual stream in shared memory, BN 64, 2 slots)
# a tile of 64 tokens costs this share of a tile of 128 (chip_tf32_variants.py
# on the H100: 27.0 against 19.5 ms for kernel 12 at t320, 1.39x a token)
BLOCK_F32_TM64_COST = 0.7


class BlockF32Plan(NamedTuple):
    tm: int  # tokens a tile: 128 (two warpgroups of 64 rows) or 64 (both on the same rows, half the columns each)


@functools.lru_cache(maxsize=None)
def block_f32_plan(C: int, F: int, tokens: int, mega: bool = False) -> BlockF32Plan:
    """The tile of kernels 10 (``mega`` False) and 12 at fp32 at width C, F
    frames and ``tokens`` tokens: 128 tokens, or 64 where the grid's waves
    of them take less time (a block takes ceil(tiles / SMs) tiles one after
    another; a tile of 64 costs :data:`BLOCK_F32_TM64_COST` of one of 128),
    which is where there are fewer tiles of 128 than SMs: kernel 10 at the
    middle block's 5120 tokens, 40 tiles of 128 for 132 SMs. Kernel 12 takes
    C <= 640 only."""
    if C % 64 or not 64 <= C <= (640 if mega else 1280) or F < 2 or 128 % F or tokens <= 0 or tokens % F:
        raise ValueError(f"block_f32_plan: C a multiple of 64 up to {640 if mega else 1280}, F dividing 128 and "
                         f"whole rows of F tokens; got C={C} F={F} tokens={tokens}")
    if F > 64:
        return BlockF32Plan(128)
    waves = {tm: -(-tokens // (tm * GEMM_SMS)) for tm in (128, 64)}
    return BlockF32Plan(64 if waves[64] * BLOCK_F32_TM64_COST < waves[128] else 128)


def block_f32_grid(plan: BlockF32Plan, tokens: int) -> int:
    """Blocks of a ``ds_temporal_block_f32`` / ``ds_temporal_mega_f32``
    launch: one a tile of ``plan.tm`` tokens, at most one a streaming
    multiprocessor (the grid is persistent)."""
    return min(-(-tokens // plan.tm), GEMM_SMS)


def temporal_f32_scratch(tokens: int, C: int, plan: BlockF32Plan) -> torch.Size:
    """The scratch of one launch of ``ds_temporal_block_f32`` /
    ``ds_temporal_mega_f32``, flat fp32: a slot of ``plan.tm`` token rows a
    block of the grid (:func:`block_f32_grid`) in each of three regions, one
    after another: the LayerNorm, GroupNorm or attention rows [blocks * tm,
    C], the q|k|v or GEGLU rows [blocks * tm, 4C] and the residual stream
    [blocks * tm, C]. The token tiles live there between the products: an
    fp32 tile of 128 tokens (160 KB at C 320) does not fit shared memory
    beside the weight ring."""
    return torch.Size((block_f32_grid(plan, tokens) * plan.tm * 6 * C,))



# ds_spatial_block_f32 / ds_mega_spatial_f32's tile (csrc/spatial_f32.cu):
# temporal_f32.cu's block (one 384-thread block an SM, the ring of 4 slots,
# tc_f32.cuh's products) over query tiles of TM tokens of one frame sample,
# the attention's key tiles of SPATIAL_F32_KEYS streamed through the same
# ring; each key segment's keys and values split once a launch
SPATIAL_F32_KEYS = 64


def _key_pad(n: int) -> int:
    return -(-n // SPATIAL_F32_KEYS) * SPATIAL_F32_KEYS


@functools.lru_cache(maxsize=None)
def spatial_f32_plan(C: int, N: int, samples: int) -> BlockF32Plan:
    """The query tile of kernels 11 and 13 at fp32 at width C over
    ``samples`` frame samples of N tokens: 128 tokens of a sample, or 64
    where the grid's waves of them take less time (:func:`block_f32_plan`'s
    rule: a tile of 64 costs :data:`BLOCK_F32_TM64_COST` of one of 128),
    as where there are fewer tiles of 128 than SMs. Timed on the H100
    (chip_smoke.py phase 10's tile lines): 128 is the faster at every
    batch-8 shape, 64 at N 256 (32 samples: 64 tiles of 128). A sample's last
    tile may be ragged (N 400: three of 128 and one of 16 rows)."""
    if C % 64 or not 64 <= C <= 640 or N <= 0 or N % 16 or samples <= 0:
        raise ValueError(f"spatial_f32_plan: C a multiple of 64 up to 640 and N a multiple of 16; got C={C} N={N} "
                         f"samples={samples}")
    waves = {tm: -(-samples * -(-N // tm) // GEMM_SMS) for tm in (128, 64)}
    return BlockF32Plan(64 if waves[64] * BLOCK_F32_TM64_COST < waves[128] else 128)


def spatial_f32_grid(plan: BlockF32Plan, samples: int, N: int) -> int:
    """Blocks of a ``ds_spatial_block_f32`` / ``ds_mega_spatial_f32``
    launch: one a query tile, at most one a streaming multiprocessor."""
    return min(samples * -(-N // plan.tm), GEMM_SMS)


def spatial_f32_scratch(samples: int, N: int, C: int, clips: int, lens, plan: BlockF32Plan) -> torch.Size:
    """The scratch of one launch of ``ds_spatial_block_f32`` /
    ``ds_mega_spatial_f32``, flat fp32: the three regions of
    :func:`temporal_f32_scratch` (the LayerNorm or attention rows, q2 or the
    GEGLU rows, the stream) of ``plan.tm`` rows a block of the grid, then for
    each key segment (the samples' own N tokens; each context segment of
    ``lens`` keys a clip, a length 0 absent) its keys split [2, samples,
    len, C] (hi, then lo) and its values transposed and split [2, samples,
    C, lpad] (lpad: len rounded up to a key tile, zeros past len), written
    once a launch: 1.7 GB at s320's batch-8 shape."""
    rows = spatial_f32_grid(plan, samples, N) * plan.tm
    segs = [(samples, N)] + [(clips, n) for n in lens if n]
    return torch.Size((rows * 6 * C + sum(2 * s * C * (n + _key_pad(n)) for s, n in segs),))

# ds_temporal_block / ds_temporal_mega's tile (csrc/block.cu): TM resident
# tokens a block, weight tiles of 128 rows x 64 k (16 KB) through a ring of
# `stages`, multicast to a thread-block cluster of CL blocks (each block
# alone on its weights at CL 1); the q|k|v projection hg heads at a time,
# the GEGLU hidden hc columns at a time.
BLOCK_TILE_BYTES = 128 * 64 * 2
BLOCK_LDQ = 72  # bf16 pitch of a q, k or v row
BLOCK_MAX_STAGES = 6
# the ring depth bought first, before wider head groups: at TM 16 a weight
# tile is little work, so the ring must hold more of them to hide its refill
BLOCK_MIN_STAGES = {16: 6, 32: 4, 64: 4}
# blocks a cluster shares each weight tile with, by width, where a row lies
# in one block: 2 where chip_smoke.py's tile lines timed the multicast
# faster than each block alone on its weights (C 512), else 1 (PERF.md)
BLOCK_CL_BY_WIDTH = {512: 2}
BLOCK_UNITS = 8  # 16-query attention units a head group fills: one per consumer warp


class BlockPlan(NamedTuple):
    tm: int      # tokens a block
    cl: int      # blocks a cluster
    stages: int  # ring tiles
    hg: int      # heads a q|k|v projection
    hc: int      # GEGLU hidden columns a chunk
    smem: int    # dynamic shared memory bytes, the 1024-byte alignment pad included


def block_smem(tm: int, C: int, F: int, stages: int, hg: int, hc: int) -> int:
    """Shared memory of a ``ds_temporal_block`` / ``ds_temporal_mega``
    block, as ``csrc/block.cu::layout`` reckons it: the ring, the residual
    stream, the LN output and the attention output ([tm, C] bf16 each), hg
    heads of q|k|v ([tm, 72] bf16 each) and, where a row spans blocks (F >
    tm), the row's keys and values ([2, F, 72]); the GEGLU chunk [tm, hc]
    over the attention's area; 2 x stages + 2 mbarriers; the alignment pad."""
    tile = tm * C * 2
    attn = tile + hg * 3 * tm * BLOCK_LDQ * 2 + (2 * F * BLOCK_LDQ * 2 if F > tm else 0)
    return 1024 + stages * BLOCK_TILE_BYTES + 2 * tile + max(attn, tm * hc * 2) + (2 * stages + 2) * 8


@functools.lru_cache(maxsize=None)
def block_plan(C: int, F: int, mega: bool = False) -> BlockPlan:
    """The tile of kernels 10 (``mega`` False) and 12 at width C and F
    frames: TM by width (64 at C <= 320, 32 at C <= 640, else 16: what the
    three [TM, C] tiles and a 4-deep ring leave room for); CL from
    :data:`BLOCK_CL_BY_WIDTH`, or F / TM where a row spans more blocks (a
    cluster holds whole rows; larger clusters measured slower, PERF.md); hc
    the widest multiple of 128 that divides 4C and is at most C (the chunk
    fits in the attention's area); then the widest head group (at most
    :data:`BLOCK_UNITS` units of 16 queries; one head where a row spans
    blocks) beside :data:`BLOCK_MIN_STAGES` ring stages (fewer only where
    one head does not fit beside them), and as many stages as the rest
    holds. Kernel 12 takes C <= 640 only."""
    if mega and C > 640:
        raise ValueError(f"block_plan: kernel 12 takes C <= 640, got {C}")
    tm = 64 if C <= 320 else 32 if C <= 640 else 16
    rb = F // tm if F > tm else 1
    cl = max(rb, BLOCK_CL_BY_WIDTH.get(C, 1))
    hc = max([h for h in range(128, C + 1, 128) if (4 * C) % h == 0], default=128)
    heads = C // 64
    hg_max = 1 if rb > 1 else max(1, min(heads, BLOCK_UNITS * 16 // tm))
    for need in range(BLOCK_MIN_STAGES[tm], 1, -1):
        hg = next((h for h in range(hg_max, 0, -1) if block_smem(tm, C, F, need, h, hc) <= GEMM_SMEM_MAX), None)
        if hg is not None:
            break
    else:
        raise ValueError(f"block_plan: no tile fits C={C} F={F}")
    stages = max(s for s in range(need, BLOCK_MAX_STAGES + 1) if block_smem(tm, C, F, s, hg, hc) <= GEMM_SMEM_MAX)
    return BlockPlan(tm, cl, stages, hg, hc, block_smem(tm, C, F, stages, hg, hc))


def block_grid(plan: BlockPlan, tokens: int) -> int:
    """Blocks of a ``ds_temporal_block`` / ``ds_temporal_mega`` launch over
    ``tokens`` F-frame tokens, as ``csrc/block.cu::launch`` sizes the grid:
    ceil(tokens / TM) rounded up to whole clusters."""
    tiles = -(-tokens // plan.tm)
    return -(-tiles // plan.cl) * plan.cl


def block_maps(cache: dict, weights, C: int, cl: int):
    """The TMA maps of a block's weights (``ds_block_maps``: wqkv1, wo1,
    wqkv2, wo2, w1, w2[, w_in, w_out]) for clusters of ``cl``, encoded at
    the first call and kept in ``cache`` by cluster size: the ``maps`` dict
    of the packed operands that hold these weights, so a map lives exactly
    as long as the addresses it names. Returns a pointer for
    ``ds_temporal_block`` / ``ds_temporal_mega``."""
    buf = cache.get(cl)
    if buf is None:
        buf = ctypes.create_string_buffer(128 * len(weights))
        call("ds_block_maps", ptr_array(weights), len(weights), C, cl, ctypes.cast(buf, ctypes.c_void_p))
        cache[cl] = buf
    return ctypes.cast(buf, ctypes.c_void_p)


def block_clusters(plan: BlockPlan, mega: bool = False) -> int:
    """How many clusters of ``plan`` the card holds at once
    (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    call("ds_block_clusters", int(mega), plan.tm, plan.cl, plan.smem, ctypes.byref(n))
    return n.value


# ds_spatial_block / ds_mega_spatial's tile (csrc/mega.cu): TM query tokens
# of one sample a block (TM 64 at C <= 320, else 32), a ring of `stages` 16
# KB slots holding weight tiles and the attention's 64-key K/V tiles (an
# even number of slots, at least 4: the two heads of a pair keep to slots of
# their own), the GEGLU hidden hc columns at a time.
SPATIAL_MAX_STAGES = 8


class SpatialPlan(NamedTuple):
    tm: int      # query tokens a block
    stages: int  # ring slots
    hc: int      # GEGLU hidden columns a chunk
    smem: int    # dynamic shared memory bytes, the 1024-byte alignment pad included


def spatial_smem(tm: int, C: int, stages: int, hc: int) -> int:
    """Shared memory of a ``ds_spatial_block`` / ``ds_mega_spatial`` block,
    as ``csrc/mega.cu::layout`` reckons it: the ring, the residual stream X
    and the tiles H and O ([tm, C] bf16 each); O also holds the GEGLU chunk
    [tm, hc] and, past its end, the 64 - tm rows that a 64-row query operand
    read from its last head runs over; 2 x stages mbarriers; the alignment
    pad."""
    tile = tm * C * 2
    o = max(tile + (64 - tm) * 128, tm * hc * 2)
    return 1024 + stages * BLOCK_TILE_BYTES + 2 * tile + o + 2 * stages * 8


@functools.lru_cache(maxsize=None)
def spatial_plan(C: int) -> SpatialPlan:
    """The tile of kernels 11 and 13 at width C (their shared memory does not
    depend on N, the context or the wrapper): TM 64 at C <= 320, else 32
    (three [TM, C] tiles beside a ring of at least 4 slots); hc the widest
    multiple of 128 that divides 4C and is at most C (the chunk lies in O);
    as many ring slots as the rest leaves room for, an even number up to
    :data:`SPATIAL_MAX_STAGES`."""
    if C % 64 or not 64 <= C <= 640:
        raise ValueError(f"spatial_plan: kernels 11 and 13 take C a multiple of 64 up to 640, got {C}")
    tm = 64 if C <= 320 else 32
    hc = max([h for h in range(128, C + 1, 128) if (4 * C) % h == 0], default=128)
    stages = max(s for s in range(4, SPATIAL_MAX_STAGES + 1, 2) if spatial_smem(tm, C, s, hc) <= GEMM_SMEM_MAX)
    return SpatialPlan(tm, stages, hc, spatial_smem(tm, C, stages, hc))


def spatial_grid(plan: SpatialPlan, samples: int, N: int) -> int:
    """Blocks of a ``ds_spatial_block`` / ``ds_mega_spatial`` launch: one a
    (sample, query tile), ceil(N / TM) tiles a sample (the last ragged where
    TM does not divide N)."""
    return samples * -(-N // plan.tm)


def spatial_maps(cache: dict, weights, C: int):
    """The TMA maps of the body's weights (``ds_spatial_maps``: wo1, wq2,
    wo2, w1, w2[, w_out]), encoded at the first call and kept in ``cache``
    (the ``maps`` dict of the packed operands that hold these weights).
    Returns a pointer for ``ds_spatial_block`` / ``ds_mega_spatial``."""
    buf = cache.get("spatial")
    if buf is None:
        buf = ctypes.create_string_buffer(128 * len(weights))
        call("ds_spatial_maps", ptr_array(weights), len(weights), C, ctypes.cast(buf, ctypes.c_void_p))
        cache["spatial"] = buf
    return ctypes.cast(buf, ctypes.c_void_p)


# ds_gn_stats (csrc/gn_silu.cu): a block of about 256 threads (lanes x C / 8)
# sums 32 rows a thread of one sample
GN_STATS_THREADS = 256
GN_STATS_ROWS_PER_THREAD = 32
# ds_group_norm_silu's cluster route: blocks of about 512 threads, at most 16
# a cluster (one a sample)
GN_CLUSTER_THREADS = 512
GN_CLUSTER_MAX = 16
# ds_group_norm_silu's route argument: the index of the route's name
GN_ROUTES = ("cluster", "split", "grid")
# the grid route's blocks: one an SM, all resident (the H100 SXM has 132 SMs;
# the wrapper passes the card's own count)
GN_GRID_SMS = 132


def gn_stats_splits(B: int, M: int, C: int) -> int:
    """The row splits of one sample in ``ds_gn_stats``: a block's lanes
    (``GN_STATS_THREADS // (C / 8)``, at least 1) times 32 rows each, every
    split non-empty."""
    lanes = max(1, GN_STATS_THREADS // (C // 8))
    return -(-M // (lanes * GN_STATS_ROWS_PER_THREAD))


def gn_cluster_lanes(C: int) -> int:
    """Rows a cluster-route block takes at a time: a thread a 16-byte chunk
    of a row, as many rows as :data:`GN_CLUSTER_THREADS` allow, at least
    one (``csrc/gn_silu.cu::row_map``)."""
    return max(1, GN_CLUSTER_THREADS // (C // 8))


def gn_cluster_smem(rows: int, C: int, G: int, elem: int = 2) -> int:
    """Shared memory of a cluster-route (or grid-route) block of
    ``ds_group_norm_silu``, as ``csrc/gn_silu.cu::cluster_smem`` reckons it:
    the slab [rows, C] of ``elem``-byte elements (2 bf16, 4 fp32), the row
    lanes' fp32 sums [lanes, C], the block's per-channel sums [2, C] and two
    [2, G] fp32 group arrays."""
    return elem * rows * C + ((gn_cluster_lanes(C) + 2) * C + 4 * G) * 4


def gn_fit_rows(C: int, G: int, elem: int) -> int:
    """Rows of ``elem``-byte elements at width C that a cluster- or
    grid-route block holds in shared memory beside its reduction arrays."""
    return (GEMM_SMEM_MAX - gn_cluster_smem(0, C, G)) // (elem * C)


class GnPlan(NamedTuple):
    route: str   # "cluster" (the slab in shared memory), "split" (statistics pass, then apply) or "grid"
    cs: int      # blocks a cluster, one cluster a sample; on the grid route blocks a sample (0 on the split route)
    rows: int    # rows of a sample a cluster or grid block takes, or a statistics split sums
    smem: int    # dynamic shared memory bytes of a cluster or grid block, or of a statistics block
    splits: int  # row splits of a sample's statistics; on the grid route samples a pass (0 on the cluster route)


def gn_grid_held(plan: GnPlan, C: int, G: int = 32, elem: int = 4) -> int:
    """Rows of the ``plan.rows`` a grid-route block takes that it holds in
    shared memory (the rest it reads again in the apply)."""
    return min(plan.rows, gn_fit_rows(C, G, elem))


def gn_grid_scratch(plan: GnPlan, B: int, C: int, G: int = 32) -> int:
    """fp32 elements of the grid route's scratch: the folded mul | add [2, B,
    C], the blocks' group partials of two passes [2, splits * cs, 2, G] and
    the barrier's counter (4 elements, the first an int)."""
    return 2 * B * C + 4 * plan.splits * plan.cs * G + 4


def sm_count(device: torch.device) -> int:
    """SMs of a CUDA ``device`` (the grid route's blocks); :data:`GN_GRID_SMS`
    for a tensor off the card (the tests' stand-in for one)."""
    if device.type != "cuda":
        return GN_GRID_SMS
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _gn_cluster(M: int, C: int, G: int, elem: int):
    """The cluster plan where a sample's slab fits the shared memory of at
    most :data:`GN_CLUSTER_MAX` blocks, else None (see :func:`gn_plan`)."""
    fit = gn_fit_rows(C, G, elem)
    if fit < 1 or -(-M // fit) > GN_CLUSTER_MAX or 2 * G * GN_CLUSTER_MAX > gn_cluster_lanes(C) * C:
        return None
    cs = -(-M // fit)
    cs = 16 if cs > 8 else 8 if cs > 5 else cs
    rows = -(-M // min(cs, M))
    return GnPlan("cluster", -(-M // rows), rows, gn_cluster_smem(rows, C, G, elem), 0)


def _gn_grid(B: int, M: int, C: int, G: int, elem: int, sms: int) -> GnPlan:
    """The grid plan: as many whole samples a pass as the card's shared
    memory holds (``sms`` blocks of :func:`gn_fit_rows` rows), the passes
    balanced, each sample spread over ``sms // per pass`` blocks; a sample
    larger than that takes every block alone, its rows past the slab read
    again in the apply."""
    fit = gn_fit_rows(C, G, elem)
    need = -(-M // fit)  # blocks a sample's slab needs
    if need > sms:
        per_pass = 1
    else:
        passes = -(-B // min(B, sms // need))
        per_pass = -(-B // passes)
    rows = -(-M // min(sms // per_pass, M))
    return GnPlan("grid", -(-M // rows), rows, gn_cluster_smem(min(rows, fit), C, G, elem), per_pass)


def _gn_split(B: int, M: int, C: int) -> GnPlan:
    splits = gn_stats_splits(B, M, C)
    lanes = max(1, GN_STATS_THREADS // (C // 8))
    return GnPlan("split", 0, -(-M // splits), 2 * lanes * C * 4, splits)


@functools.lru_cache(maxsize=None)
def gn_plan(B: int, M: int, C: int, G: int = 32, elem: int = 2, sms: int = GN_GRID_SMS,
            route: str | None = None) -> GnPlan:
    """The route of ``ds_group_norm_silu`` for x [B, M, C] of ``elem``-byte
    elements (2 bf16, 4 fp32), GroupNorm over G groups per sample, on a card
    of ``sms`` SMs.

    * "cluster" (x read once) where a sample's slab fits the shared memory
      of at most :data:`GN_CLUSTER_MAX` blocks: the fewest blocks that hold
      it, except that 6 or 7 become 8 and 9 to 15 become 16 (at one block an
      SM the H100 holds 15 clusters of 8 and 7 of 16 at once, 120 and 112
      SMs, but 17 of 6, 15 of 7 and 7 to 9 of 9 to 15: chip_smoke.py phase 1
      prints the table), then as many as whole non-empty row ranges allow.
    * "split": the statistics at :func:`gn_stats_splits` row splits, then
      the apply (x read twice).
    * "grid" (fp32 only): one cooperative launch of at most ``sms`` blocks
      that walks the samples in passes (:func:`_gn_grid`; x read once where
      a sample fits the card's shared memory).

    bf16 and fp32 take "cluster" where it holds; else bf16 "split" and
    fp32 "grid" (chip_smoke.py phase 10 times every fp32 shape on each
    route: the grid beats the split route at every shape, and neither it
    nor the cluster route is faster at every shape where both hold; PERF.md
    has the table). ``route`` names a route to take instead; a route that
    does not hold raises."""
    if B <= 0 or M <= 0 or C % 8 or not 0 < C <= 6144 or G <= 0 or C % G or elem not in (2, 4) or sms <= 0:
        raise ValueError(f"gn_plan: needs B, M > 0, C % 8 == 0, C <= 6144, C % G == 0, 2- or 4-byte elements; "
                         f"got B={B} M={M} C={C} G={G} elem={elem} sms={sms}")
    cluster = _gn_cluster(M, C, G, elem)
    if route is None:
        route = "cluster" if cluster is not None else "split" if elem == 2 else "grid"
    if route == "cluster":
        if cluster is None:
            raise ValueError(f"gn_plan: a sample of {M} x {C} does not fit the shared memory of "
                             f"{GN_CLUSTER_MAX} cluster blocks")
        return cluster
    if route == "grid":
        if elem != 4:
            raise ValueError("gn_plan: the grid route takes 4-byte (fp32) elements")
        return _gn_grid(B, M, C, G, elem, sms)
    if route == "split":
        return _gn_split(B, M, C)
    raise ValueError(f"gn_plan: no route {route!r}; the routes are {GN_ROUTES}")


def gn_clusters(plan: GnPlan, C: int) -> int:
    """How many clusters of a cluster-route ``plan`` at width C the card
    holds at once (``cudaOccupancyMaxActiveClusters``)."""
    n = ctypes.c_int(0)
    call("ds_gn_clusters", plan.cs, C, plan.smem, ctypes.byref(n))
    return n.value


def _frame_rows(M: int, F: int, HW: int) -> torch.Tensor:
    """Stored row of each logical row r = (b*HW + hw)*F + f of a
    [B, F, H, W, .] tensor: (b*F + f)*HW + hw."""
    r = torch.arange(M)
    f, bhw = r % F, r // F
    b, hw = bhw // HW, bhw % HW
    return (b * F + f) * HW + hw


def ln_gemm_plain(x2d, w, *, ln=None, eps=1e-5, gn=None, rows_per_sample=0, frame_map=None, bias=None,
                  residual=None, mode=MODE_STORE):
    """Plain PyTorch version of ``ds_ln_gemm`` (arguments as :func:`ln_gemm`),
    with its rounding points: the prologue in fp32 (LayerNorm fast variance;
    GroupNorm product and sum rounded separately), the normalised activation
    rounded to the activation type, the product accumulated in fp32, bias
    added in fp32, then rounded; the residual added in the activation type;
    GEGLU on the rounded value and gate (at fp32 none of these roundings
    exists, and the products are exact fp32, which ``ds_ln_gemm_f32``'s
    three tf32 products match to fp32's error). Never on the main path: the
    reference for the kernels in tests and ``chip_smoke.py``."""
    M, K = x2d.shape
    N = w.shape[0]
    dt = x2d.dtype
    x = x2d
    map_f, map_hw = frame_map or (0, 0)
    rows = _frame_rows(M, map_f, map_hw).to(x2d.device) if frame_map is not None else None
    if gn is not None and rows is not None:
        x = x[rows]
    xf = x.float()
    if ln is not None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
        a = ((xf - mu) * (torch.rsqrt(var + eps) * ln[0].float()) + ln[1].float()).to(dt)
    elif gn is not None:
        s = torch.arange(M, device=x2d.device) // rows_per_sample
        a = (xf * gn[0].float()[s] + gn[1].float()[s]).to(dt)
    else:
        a = x
    acc = torch.matmul(a.float(), w.float().t())
    if bias is not None:
        acc = acc + bias.float()
    if mode == MODE_GEGLU:
        val, gate = acc.to(dt).float().chunk(2, dim=-1)
        return (val * torch.nn.functional.gelu(gate, approximate="none")).to(dt)
    y = acc.to(dt)
    if mode == MODE_RESIDUAL:
        res = residual if rows is None else residual[rows]
        y = (y.float() + res.float()).to(dt)
    if rows is not None and gn is None:
        out = torch.empty_like(y)
        out[rows] = y
        y = out
    return y


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` and
    ``hopper.cuh::tf32_rna`` round it (to nearest, ties away from zero: the
    13 low mantissa bits cleared after adding half their range to the
    magnitude; inf and NaN unchanged). A plain model of the split for the
    tests; the kernels never call it."""
    bits = x.float().contiguous().view(torch.int32)
    special = (bits & 0x7F800000) == 0x7F800000
    return torch.where(special, bits, (bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi), as ``hopper.cuh::
    split_tf32`` computes them (a plain model for the tests)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor, *, terms: int = 3, bk: int = GEMM_F32_BK) -> torch.Tensor:
    """A plain model of the fp32 kernels' products: a [M, K] @ b [K, N] with
    both operands split (:func:`split_tf32`); each k step of ``bk`` sums its
    products a_lo.b_hi + a_hi.b_lo + a_hi.b_hi exactly (tf32 products are
    exact in fp32; float64 here) into a partial rounded to fp32, and the
    partials are added in fp32, one step after another, as a consumer of
    ``ds_ln_gemm_f32`` adds a stage's accumulator to the tile's.
    ``terms=1``: a_hi.b_hi alone, one tf32 product. For the tests only."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], bk):
        s = slice(k, k + bk)
        part = ah[:, s] @ bh[s] if terms == 1 else (ah[:, s] + al[:, s]) @ (bh[s] + bl[s]) - al[:, s] @ bl[s]
        acc = acc + part.float()
    return acc


def _check_ln_gemm(M, K, N, *, ln, gn, rows_per_sample, frame_map, residual, mode):
    """Raise ValueError for an argument combination or shape that
    ``ds_ln_gemm`` does not take (the same rules on every device)."""
    if mode not in (MODE_STORE, MODE_RESIDUAL, MODE_GEGLU):
        raise ValueError(f"ln_gemm: unknown mode {mode}")
    n_out = N // 2 if mode == MODE_GEGLU else N
    if K % 32 or N % 64 or n_out % 32:
        raise ValueError(f"ln_gemm: needs K % 32 == 0 and N % 64 == 0, got K={K} N={N}")
    if (mode == MODE_RESIDUAL) != (residual is not None):
        raise ValueError(f"ln_gemm: a residual is read exactly in MODE_RESIDUAL, got mode={mode} "
                         f"residual={'given' if residual is not None else 'None'}")
    if gn is not None:
        if ln is not None or mode != MODE_STORE or rows_per_sample <= 0 or M % rows_per_sample:
            raise ValueError(f"ln_gemm: the GroupNorm prologue takes mode 0 and whole samples, got "
                             f"mode={mode} M={M} rows_per_sample={rows_per_sample}")
    if frame_map is not None:
        map_f, map_hw = frame_map
        if map_f <= 0 or map_hw <= 0 or M % (map_f * map_hw) or ln is not None \
                or (gn is None) != (mode == MODE_RESIDUAL):
            raise ValueError(f"ln_gemm: frame_map {frame_map} takes the GroupNorm head or the "
                             f"residual tail over whole clips, got M={M} mode={mode}")
        if gn is not None and rows_per_sample % (map_f * map_hw):
            raise ValueError(f"ln_gemm: the GroupNorm head's samples are whole clips, so rows_per_sample must "
                             f"be a multiple of F*H*W; got F={map_f} H*W={map_hw} rows_per_sample={rows_per_sample}")


def ln_gemm(x2d, w, *, ln=None, eps=1e-5, gn=None, rows_per_sample=0, frame_map=None, bias=None,
            residual=None, mode=MODE_STORE):
    """Launch ``csrc/gemm.cu::ds_ln_gemm`` or ``ds_ln_gemm_pingpong`` (bf16,
    the schedule :func:`gemm_tile` picks, counted in ``ln_gemm.launches``) or
    ``csrc/gemm_f32.cu::ds_ln_gemm_f32`` (fp32), by the activation type:
    ``epilogue(prologue(x2d) @ w.T)``. A bf16 launch is also counted by
    (schedule, BN) in ``ln_gemm.launches_by_width``.

    x2d [M, K] bf16 or fp32; w [N, K] and residual [M, N] (``MODE_RESIDUAL``
    only) of x2d's type; bias fp32 [N]. ``MODE_GEGLU`` returns [M, N / 2].
    Prologue: ``ln`` (scale, bias) fp32 [K] (LayerNorm per row), or ``gn``
    (mul, add) fp32 [M / rows_per_sample, K] (folded GroupNorm per sample,
    mode 0 only). ``frame_map = (F, HW)`` reads the rows of x2d (with ``gn``)
    or writes the output rows and reads the residual rows (``MODE_RESIDUAL``)
    in the frame-major order of a [B, F, H, W, .] tensor, logical row
    ``(b*HW + hw)*F + f``. Combinations the kernel does not take, and a
    mix of activation types, raise ValueError on every device; CPU tensors
    take :func:`ln_gemm_plain`. An fp32 ``w`` is split for the tensor cores
    at its first use (:func:`tf32_split_weights`)."""
    M, K = x2d.shape
    N = w.shape[0]
    n_out = N // 2 if mode == MODE_GEGLU else N
    dt = check_dtypes("ln_gemm", x2d, w, residual)
    _check_ln_gemm(M, K, N, ln=ln, gn=gn, rows_per_sample=rows_per_sample, frame_map=frame_map,
                   residual=residual, mode=mode)
    if not use_kernel(x2d, w):
        return ln_gemm_plain(x2d, w, ln=ln, eps=eps, gn=gn, rows_per_sample=rows_per_sample,
                             frame_map=frame_map, bias=bias, residual=residual, mode=mode)
    check_operand("x", x2d, dt)
    check_operand("w", w, dt, (N, K))
    if ln is not None:
        check_operand("ln scale", ln[0], torch.float32, (K,))
        check_operand("ln bias", ln[1], torch.float32, (K,))
    if gn is not None:
        check_operand("gn mul", gn[0], torch.float32, (M // rows_per_sample, K))
        check_operand("gn add", gn[1], torch.float32, (M // rows_per_sample, K))
    if bias is not None:
        check_operand("bias", bias, torch.float32, (N,))
    if residual is not None:
        check_operand("residual", residual, dt, (M, n_out))
    y = torch.empty((M, n_out), device=x2d.device, dtype=dt)
    map_f, map_hw = frame_map or (0, 0)
    # the prologue pass's normalised rows, read by the GEMM
    scratch = torch.empty_like(x2d) if ln is not None or gn is not None else None
    if dt == torch.float32:
        name, tile, w = "ds_ln_gemm_f32", gemm_f32_tile(M, K, N, mode), tf32_split_weights(w)
    else:
        tile = gemm_tile(M, K, N, mode)
        name = _GEMM_ENTRY[tile.schedule]
    call(
        name, ptr(x2d), M, K, ptr(ln[0] if ln else None), ptr(ln[1] if ln else None),
        float(eps), ptr(gn[0] if gn else None), ptr(gn[1] if gn else None), int(rows_per_sample),
        int(map_f), int(map_hw), ptr(w), N, ptr(bias), ptr(residual), ptr(y), mode, ptr(scratch),
        tile.block_n, tile.stages,
    )
    if dt != torch.float32:
        ln_gemm.launches[tile.schedule] += 1
        ln_gemm.launches_by_width[tile.schedule, tile.block_n] += 1
    return y


# bf16 launches by schedule, and by (schedule, BN) (the fp32 kernel has one)
ln_gemm.launches = dict.fromkeys(GEMM_BLOCK_N, 0)
ln_gemm.launches_by_width = {(s, bn): 0 for s, widths in GEMM_BLOCK_N.items() for bn in widths}
