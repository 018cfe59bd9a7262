"""The reader of ``decode_attention_device_ms.serve`` on synthetic traces
(CPU, no card): the decode_attn kernels' device time a decode step, and
nothing where the trace holds no such kernel."""
import importlib.util
from pathlib import Path

import pytest

from cbench import harness

HERE = Path(__file__).resolve().parent
NAME = "decode_attention_device_ms.serve"


def _reader():
    spec = importlib.util.spec_from_file_location(
        "m_" + harness._ident(NAME), HERE / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_device_ms_a_decode_step_of_the_decode_attn_kernels():
    tr = {"info": {"prefills": 1, "decode_steps": 4},
          "by_name_s": {
              "void (anonymous namespace)::decode_attn_simt_kernel<"
              "__nv_bfloat16, 16, 1, 1>((anonymous namespace)::Params)":
                  0.010,
              "void (anonymous namespace)::decode_attn_combine_kernel<"
              "__nv_bfloat16>((anonymous namespace)::Params)": 0.002,
              "void (anonymous namespace)::flash_fwd_wg_kernel<128, 128>("
              "(anonymous namespace)::WgParams)": 1.0,
              "nvjet_tst_128x16_64x8": 5.0}}
    got = _reader().read({"kind": "serve", "trace": tr})
    assert got == pytest.approx(3.0)


def test_none_without_the_kernel_or_the_trace():
    read = _reader().read
    tr = {"info": {"prefills": 1, "decode_steps": 4},
          "by_name_s": {"void at::native::elementwise_kernel<128, 2>": 1.0}}
    assert read({"kind": "serve", "trace": tr}) is None
    assert read({"kind": "serve"}) is None
    assert read({"kind": "train", "trace": tr}) is None
