"""The one seam through which the port's kernel wrappers reach their CUDA
libraries (``kernels/build.py``: ``on_card``, ``kernel``, ``launch``),
driven on the CPU.  Each wrapper's card branch runs on meta tensors (shapes
and strides, no bytes) with the seam's device entry replaced by a
recorder: the library functions are stand-ins that check every argument
against the types the wrapper bound them with and return a chosen
``cudaError``.  For each wrapper that shows the library and functions it
binds, that each of its counters moves by one a launch (the backward's
route counter by two, one a pass), and that a failed launch raises,
naming the kernel, and counts nothing."""
import ctypes

import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import checksum as ck
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import shard_pack as sp
from repro_torch.kernels import ssd_decode as sd


class _Function:
    """A library function as ``build.kernel`` binds it; each call checks
    its arguments against ``argtypes`` with ctypes' own conversion."""

    def __init__(self, lib, name, log, err):
        self.lib, self.name, self.log, self.err = lib, name, log, err
        self.argtypes = self.restype = None

    def __call__(self, *args):
        assert self.restype is ctypes.c_int
        assert len(args) == len(self.argtypes)
        for t, a in zip(self.argtypes, args):
            t.from_param(a)
        self.log.append((self.lib, self.name, args))
        return self.err[0]


class _Library:
    def __init__(self, lib, log, err):
        self.lib, self.log, self.err = lib, log, err

    def __getattr__(self, name):
        return _Function(self.lib, name, self.log, self.err)


def record_launches(monkeypatch, err=0):
    """Drive the wrappers' card branches on meta tensors: every device
    counts as the card, libraries are stand-ins returning ``err``, and
    ``launch`` calls the bound function with stream 0, no device guard.
    Returns the log of (library, function, arguments) a call, and a
    one-item list holding the code the stand-ins return."""
    log, code = [], [err]

    def launch(fn, device, *args, what):
        build.raise_on_error(fn(*args, 0), what)

    monkeypatch.setattr(build, "_FNS", {})
    monkeypatch.setattr(build, "load", lambda lib: _Library(lib, log, code))
    monkeypatch.setattr(build, "on_card", lambda device, who="": True)
    monkeypatch.setattr(build, "launch", launch)
    return log, code


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flash_inputs():
    B, S, Hq, n_kv, D = 2, 200, 8, 2, 128
    q5 = _meta(B, S, Hq, D).reshape(B, S, n_kv, Hq // n_kv, D) \
        .permute(0, 2, 3, 1, 4)
    k4 = _meta(B, S, n_kv, D).permute(0, 2, 1, 3)
    return q5, k4


def _flash_fwd():
    q5, k4 = _flash_inputs()
    fa.flash_fwd(q5, k4, k4, causal=True)


def _flash_bwd():
    q5, k4 = _flash_inputs()
    lse = _meta(*q5.shape[:4], dtype=torch.float32)
    fa.flash_bwd(q5, k4, k4, q5, lse, lse, causal=True)


def _decode_attn():
    q, kv, cache = _meta(2, 1, 8, 128), _meta(2, 1, 1, 128), \
        _meta(2, 64, 1, 128)
    da.decode_attn(q, kv, kv, cache, cache, 40, 1.0, 10000.0, False)


def _ssd_decode():
    # the card branch itself: on meta the wrapper takes its twin
    B, H, N, P, K = 2, 4, 16, 16, 4
    C = H * P + 2 * N
    params = {"conv": _meta(K, C), "conv_bias": _meta(C),
              **{n: _meta(H, dtype=torch.float32)
                 for n in ("dt_bias", "a_log", "d_skip")}}
    sd._launch(_meta(B, 1, 2 * H * P + 2 * N + H), params,
               _meta(B, H, N, P, dtype=torch.float32), _meta(B, K - 1, C))


# wrapper -> (its call on meta tensors, the (library, function) pairs it
# launches in order, {(module, counter, key or None): increment}, what a
# failed first launch's message opens with)
CASES = {
    "flash_fwd": (_flash_fwd, [("flash_fwd", "flash_fwd")],
                  {(fa, "LAUNCHES", None): 1,
                   (fa, "FWD_ROUTE_LAUNCHES", "wgmma"): 1},
                  "flash_fwd (wgmma route)"),
    "flash_bwd": (_flash_bwd, [("flash_bwd", "flash_bwd_dq"),
                               ("flash_bwd", "flash_bwd_dkv")],
                  {(fa, "BWD_DQ_LAUNCHES", None): 1,
                   (fa, "BWD_DKV_LAUNCHES", None): 1,
                   (fa, "BWD_ROUTE_LAUNCHES", "wgmma"): 2},
                  "flash_bwd dq (wgmma route)"),
    "quantize": (lambda: qz.quantize(_meta(16, qz.GROUP)),
                 [("quantize", "quantize")],
                 {(qz, "QUANT_LAUNCHES", None): 1}, "quantize"),
    "dequantize": (lambda: qz.dequantize(
        _meta(16, qz.GROUP, dtype=torch.int8),
        _meta(16, 1, dtype=torch.float32), torch.bfloat16),
        [("quantize", "dequantize")], {(qz, "DEQUANT_LAUNCHES", None): 1},
        "dequantize"),
    "checksum": (lambda: ck.checksum(_meta(1000, dtype=torch.uint8)),
                 [("checksum", "checksum_words")],
                 {(ck, "CHECKSUM_LAUNCHES", None): 1}, "checksum"),
    "shard_pack": (lambda: sp.shard_pack(_meta(8, 2, 128,
                                               dtype=torch.int32), 4),
                   [("shard_pack", "shard_pack")],
                   {(sp, "PACK_LAUNCHES", None): 1}, "shard_pack"),
    "shard_unpack": (lambda: sp.shard_unpack(_meta(4, 2, 2, 128,
                                                   dtype=torch.int32)),
                     [("shard_pack", "shard_unpack")],
                     {(sp, "UNPACK_LAUNCHES", None): 1}, "shard_unpack"),
    "decode_attn": (_decode_attn, [("decode_attn", "decode_attn")],
                    {(da, "DECODE_ATTN_LAUNCHES", None): 1,
                     (da, "ROUTE_LAUNCHES", "mma"): 1},
                    "decode_attn (mma route)"),
    "ssd_decode": (_ssd_decode, [("ssd_decode", "ssd_decode")],
                   {(sd, "SSD_DECODE_LAUNCHES", None): 1}, "ssd_decode"),
}


def _zero(monkeypatch, counters):
    """The counters from zero for the test, restored after it."""
    for m, n, _ in counters:
        v = getattr(m, n)
        monkeypatch.setattr(m, n, dict.fromkeys(v, 0)
                            if isinstance(v, dict) else 0)


def _counts(counters):
    return {(m, n, k): getattr(m, n) if k is None else getattr(m, n)[k]
            for m, n, k in counters}


@pytest.mark.parametrize("wrapper", sorted(CASES))
def test_each_wrapper_launches_through_the_seam(monkeypatch, wrapper):
    call, functions, counters, what = CASES[wrapper]
    log, code = record_launches(monkeypatch)
    _zero(monkeypatch, counters)
    call()
    assert [(lib, name) for lib, name, _ in log] == functions
    assert all(args[-1] == 0 for _, _, args in log)     # the stream
    for lib, name in functions:
        bound = build._FNS[lib, name]
        assert (bound.lib, bound.name) == (lib, name)
        assert bound.argtypes[-1] is ctypes.c_void_p
    assert _counts(counters) == counters
    # a failed launch raises, naming the kernel and the code; the first
    # launch fails, so nothing is counted
    code[0] = 700
    with pytest.raises(RuntimeError) as e:
        call()
    assert str(e.value) == f"{what} kernel launch failed: cudaError 700"
    assert _counts(counters) == counters
