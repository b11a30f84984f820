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
the GEMM that every op's projections run on; :class:`PackCache` keeps a
module's kernel operands packed between calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = CSRC.parent.parent
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ds_ln_gemm": (_P, _I, _I, _P, _P, _F, _P, _I, _P, _P, _P, _I, _P),
    "ds_temporal_attention": (_P, _I, _I, _I, _F, _P, _P),
    "ds_flash_attention": (_P, _I, _I, _I, _I, _P, _P, _I, _I, _P, _P, _I, _I, _I, _F, _P, _I, _P),
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
    (no-op when that file exists). Returns the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = REPO_ROOT / "build" / f"kernels-{h.hexdigest()[:16]}"
    lib = out_dir / "libdscaler.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libdscaler.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *[str(s) for s in _sources() if s.suffix == ".cu"]]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr)
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


def ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


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


def ln_gemm(x2d, w, *, ln=None, eps=1e-5, bias=None, residual=None, mode=MODE_STORE):
    """Launch ``csrc/gemm.cu::ds_ln_gemm``: ``epilogue(LN(x2d) @ w.T)``.

    x2d [M, K] bf16; w [N, K] bf16; ln (scale, bias) fp32 [K] or None;
    bias fp32 [N]; residual [M, N] bf16 for ``MODE_RESIDUAL``.
    ``MODE_GEGLU`` returns [M, N / 2]."""
    M, K = x2d.shape
    N = w.shape[0]
    n_out = N // 2 if mode == MODE_GEGLU else N
    if K % 32 or N % 64 or n_out % 32:
        raise ValueError(f"ln_gemm: needs K % 32 == 0 and N % 64 == 0, got K={K} N={N}")
    check_operand("x", x2d)
    check_operand("w", w, shape=(N, K))
    if ln is not None:
        check_operand("ln scale", ln[0], torch.float32, (K,))
        check_operand("ln bias", ln[1], torch.float32, (K,))
    if bias is not None:
        check_operand("bias", bias, torch.float32, (N,))
    if residual is not None:
        check_operand("residual", residual, shape=(M, n_out))
    y = torch.empty((M, n_out), device=x2d.device, dtype=torch.bfloat16)
    call(
        "ds_ln_gemm", ptr(x2d), M, K, ptr(ln[0] if ln else None), ptr(ln[1] if ln else None),
        float(eps), ptr(w), N, ptr(bias), ptr(residual), ptr(y), mode,
    )
    return y
