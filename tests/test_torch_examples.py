"""The port's examples run end to end on the CPU when asked to
(``--device cpu``): the serving demo (weights through the store, prefill,
decode, KV-cache offload and restore, decode identity, the hot-session
contrast), the quickstart (60 steps, the loss falls by more than 0.5, a
restore) and the injected-failure restart.  Each example asserts what
its JAX counterpart asserts."""
import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["torch_serve_kvcache", "torch_quickstart", "torch_train_restart"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, capsys):
    _load(name).main(["--device", "cpu"])
    out = capsys.readouterr().out
    want = {"torch_serve_kvcache": "decodes identically",
            "torch_quickstart": "restored checkpoint from step",
            "torch_train_restart": "recovered from injected node failure"}
    assert want[name] in out
