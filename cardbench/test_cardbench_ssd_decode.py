"""The reader of ``ssd_decode_roofline.serve`` on synthetic records (CPU, no
card): the share of the bytes granite-4.0-h-small's Mamba2 decode calls
must move, worked out by hand, and nothing where the trace holds no
``ssd_decode`` kernel."""
import importlib.util
import json
from pathlib import Path

import pytest

from cbench import harness

HERE = Path(__file__).resolve().parent
NAME = "ssd_decode_roofline.serve"
GRANITE = json.loads((HERE / "configs" / "granite-4.0-h-small.json")
                     .read_text())


def _reader():
    spec = importlib.util.spec_from_file_location(
        "m_" + harness._ident(NAME), HERE / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(by_name_s, steps=32):
    refmod = harness.load_module(HERE / "configs" / "granite-4.0-h-small.py",
                                 "granite_ref_for_ssd_reader")
    return {"kind": "serve", "spec": refmod.spec(GRANITE),
            "mix": {"batch": 16},
            "trace": {"info": {"prefills": 1, "decode_steps": steps},
                      "by_name_s": by_name_s}}


# granite's chat shape, one Mamba2 layer's call (B 16, H 128, N 128, P 64,
# K 4, conv bias; 8448 conv channels):
#   state  2 x 4 x 16 x 128 x 128 x 64  = 134,217,728
#   tail   2 x 2 x 16 x 3 x 8448        =   1,622,016
#   x B C, dt in, y out 2 x 16 x (8448 + 128 + 8192) = 536,576
#   taps and bias 2 x 5 x 8448, dt_bias A_log D 4 x 3 x 128 = 86,016
CALL_BYTES = 136_462_336


def test_call_bytes_at_granites_chat_shape():
    assert _reader().call_bytes(16, 128, 128, 64, 4, True) == CALL_BYTES


def test_share_of_the_bound_over_the_ssd_decode_kernels():
    rec = _record({
        "void (anonymous namespace)::ssd_decode_state_kernel<__nv_bfloat16>"
        "((anonymous namespace)::StateParams)": 0.0600,
        "void (anonymous namespace)::ssd_decode_conv_kernel<__nv_bfloat16>"
        "((anonymous namespace)::ConvParams)": 0.0025,
        "void (anonymous namespace)::decode_attn_simt_kernel<"
        "__nv_bfloat16, 16, 1, 1>((anonymous namespace)::Params)": 0.01,
        "nvjet_tst_256x16_64x8": 1.0})
    want = 100.0 * 32 * 36 * CALL_BYTES / 3.35e12 / 0.0625
    assert _reader().read(rec) == pytest.approx(want, rel=1e-12)
    assert 75.0 < want < 76.0


def test_none_without_the_kernel_or_the_trace():
    read = _reader().read
    rec = _record({"void at::native::elementwise_kernel<128, 2>": 1.0})
    assert read(rec) is None
    assert read({**rec, "trace": None}) is None
    assert read({**rec, "kind": "train"}) is None
    rec = _record({"ssd_decode_state_kernel": 0.06}, steps=0)
    assert read(rec) is None
