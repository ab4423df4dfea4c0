"""Build and bind the port's CUDA kernels.

The sources under ``raft_tla_tpu_torch/csrc`` are compiled with
``nvcc`` for ``sm_90a`` (one call, every source) into a shared library
with a plain C interface under ``raft_tla_tpu_torch/_build/`` and
loaded with ctypes.  The build happens at first use, never at import,
and is reused while the sources are unchanged (the library's name
carries a hash of them).  No source includes PyTorch's headers, which
keeps the build to seconds; the wrappers below check every tensor and
allocate every output with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
# claim state of csrc/probe_claim.cu per (device, VCAP): the u64 owner
# words [2, VCAP] (all-ones: no owner) and u32 state [4] (the last epoch,
# round counters); launches that share one run on one stream
_claim_scratch: Dict[Tuple[torch.device, int],
                     Tuple[torch.Tensor, torch.Tensor]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def sources():
    return sorted(CSRC.glob("*.cu"))


def build(verbose: bool = False) -> Path:
    """Compile every csrc/*.cu into one library; returns its path.
    ``verbose`` prints ptxas's registers/spills per kernel."""
    srcs = sources()
    digest = hashlib.sha256(b"".join(
        s.read_bytes() for s in srcs) + " ".join(NVCC_FLAGS).encode())
    out = BUILD / f"libraft_kernels_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def loaded() -> bool:
    """Whether this process has loaded the kernel library yet."""
    return _lib is not None


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.probe_claim_insert_cuda.argtypes = [
            *[ctypes.c_void_p] * 9, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.probe_claim_insert_cuda.restype = ctypes.c_int
        lib.probe_claim_error_string.argtypes = [ctypes.c_int]
        lib.probe_claim_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _scratch(device: torch.device, vcap: int):
    got = _claim_scratch.get((device, vcap))
    if got is None:
        # a capture would fold the owner words' reset into every replay
        # and keep the buffers in the graph's pool: an uncaptured launch
        # (the warm-up) must come first
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("probe_claim scratch for VCAP "
                               f"{vcap} first met inside a CUDA graph "
                               "capture: launch once uncaptured first")
        got = (torch.full((2, vcap), -1, dtype=torch.int64, device=device),
               torch.zeros(4, dtype=torch.int32, device=device))
        _claim_scratch[(device, vcap)] = got
    return got


def probe_claim_launch(table: torch.Tensor, keys: torch.Tensor,
                       live: torch.Tensor, max_rounds: int):
    """Launch csrc/probe_claim.cu on the current stream.  ``table``
    int32 [W, VCAP] (updated in place), keys int32 [W, M], live bool
    [M].  Returns (fresh bool [M], pos int32 [M], hovf bool 0-d,
    rounds int32 0-d, error int32 0-d), all on the table's device;
    nothing is synchronised.  ``rounds`` counts the claim rounds run;
    ``error`` is 1 if M+1 of them found no fixpoint."""
    if not table.is_cuda:
        raise ValueError("probe_claim_launch needs a CUDA table")
    if table.dtype != torch.int32 or table.dim() != 2 or \
            not table.is_contiguous():
        raise ValueError("table must be a contiguous int32 [W, VCAP]")
    W, vcap = table.shape
    if not 1 <= W <= 4 or vcap & (vcap - 1) or vcap >= 1 << 31:
        raise ValueError(f"bad table shape {tuple(table.shape)}: W in "
                         "1..4, VCAP a power of two below 2^31")
    if keys.device != table.device or keys.dtype != torch.int32 or \
            keys.dim() != 2 or keys.shape[0] != W or \
            not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int32 [W, M] on the "
                         "table's device")
    M = keys.shape[1]
    if M >= (1 << 31) - 1:
        raise ValueError(f"{M} keys: at most 2^31 - 2 per launch")
    if live.device != table.device or live.dtype != torch.bool or \
            live.shape != (M,) or not live.is_contiguous():
        raise ValueError("live must be a contiguous bool [M] on the "
                         "table's device")
    if not 0 < max_rounds < 1 << 16:
        raise ValueError(f"max_rounds {max_rounds} out of range")
    fresh = torch.empty(M, dtype=torch.bool, device=table.device)
    pos = torch.empty(M, dtype=torch.int32, device=table.device)
    out = torch.empty(3, dtype=torch.int32, device=table.device)
    k0 = torch.empty(M, dtype=torch.int32, device=table.device)
    owner, state = _scratch(table.device, vcap)
    lib = library()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.probe_claim_insert_cuda(
            table.data_ptr(), keys.data_ptr(), live.data_ptr(),
            fresh.data_ptr(), pos.data_ptr(), out.data_ptr(),
            owner.data_ptr(), state.data_ptr(), k0.data_ptr(), W, vcap, M,
            max_rounds, stream)
    if rc != 0:
        raise RuntimeError("probe_claim kernel launch failed: "
                           f"{lib.probe_claim_error_string(rc).decode()}")
    return fresh, pos, out[0] != 0, out[1], out[2]
