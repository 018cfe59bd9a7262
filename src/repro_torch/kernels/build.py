"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` at the root of
the checkout, at first use, and loaded with ``ctypes``.  The hash covers
every file under ``csrc/`` and the compiler flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs when the
module is imported.

It is also the one seam through which a wrapper reaches its library:
``on_card`` sends a call to its kernel or to its plain twin by the
device, ``kernel`` binds a C function once (its arguments, the stream
last, and an ``int`` ``cudaError`` return), and ``launch`` calls it on a
tensor's device and current stream and raises where it failed.  The
dtype codes and card constants that several wrappers share are here too.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_fwd", "flash_bwd", "quantize", "checksum", "shard_pack",
           "decode_attn", "ssd_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# the kernels' dtype argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest head the attention kernels take
MAX_HEAD_DIM = 256
# The H100's SM count, fixed here (not read from the card) so that the
# chunking and split plans, and with them every rounding, depend on the
# shape alone.
NUM_SMS = 132

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}


def cuda_tool(name: str) -> str | None:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``), or None."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / name
    return str(path) if path.exists() else shutil.which(name)


def _nvcc() -> str:
    found = cuda_tool("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build_all(names=SOURCES, ptxas_verbose: bool = False) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns each name's compiler output (``-Xptxas -v`` prints
    registers, shared memory and spills when ``ptxas_verbose``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_verbose
                                       else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def kernel(lib: str, name: str, argtypes):
    """The C function ``name`` of ``csrc/<lib>.cu``, bound once: its
    ``argtypes`` with the stream appended, returning its ``cudaError``."""
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [*argtypes, ctypes.c_void_p]
        _FNS[lib, name] = fn
    return fn


def on_card(device: torch.device, who: str = "") -> bool:
    """True where a call on ``device`` launches its kernel, False on the
    CPU, where its wrapper computes the plain twin; raises for any other
    device (``who`` opens the message)."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{who} runs on cuda or cpu, not {device}".lstrip())
    return True


def launch(fn, device: torch.device, *args, what: str) -> None:
    """Call a function that ``kernel`` bound with ``args`` and the current
    stream of ``device`` under its device guard.  The stream's raw handle
    is read at each call, without building a ``Stream`` object, so a
    launch inside a CUDA-graph capture lands on the capture's stream."""
    with torch.cuda.device(device):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(device.index))
    raise_on_error(err, what)


def raise_on_error(err: int, what: str) -> None:
    """A non-zero ``cudaError`` from ``what``'s launch as a RuntimeError."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
