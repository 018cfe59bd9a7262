"""The port does all that the JAX package does, held name by name.

The reference (``src/repro/``) is read as text with ``ast``: nothing of it,
and nothing of JAX, is imported here.

* Names: every top-level ``def``/``class`` of every reference module is
  defined (``def``, ``class`` or assignment) in the port module at the same
  relative path under ``src/repro_torch/``, or stands in ``NO_COUNTERPART``
  with its reason and, where there is one, its counterpart in the port.
  The table also lists the two whole modules the port has no file for.  An
  entry that no longer matches the reference, that the port has made
  redundant, or whose counterpart is gone fails the table's test.
* Kernels: every ``pallas_call`` in the reference is a key of ``KERNELS``,
  which names its CUDA source, its wrapper, launch counter and plain twin
  in ``repro_torch.kernels``, and the key under which ``chip_smoke.py``'s
  ``_counters()`` reads that counter.

To extend: a new reference function is ported under its own name in the
port module at the same path, or gets a ``NO_COUNTERPART`` entry
``"module.py:name": (reason, "port_module.py:name" or a port file or
None)``; a new Pallas site gets a CUDA kernel, a wrapper with a counter and
a twin, a ``chip_smoke.py`` phase and a ``KERNELS`` row.  The helpers take
their roots as arguments, so the negative cases run them on a synthetic
reference under ``tmp_path``.
"""
import ast
import importlib
import pathlib
from typing import NamedTuple

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
CHIP_SMOKE = ROOT / "chip_smoke.py"

PALLAS = ("Pallas kernel body, launcher or TPU tiling plumbing: the CUDA "
          "kernel in kernels/csrc/ and its wrapper")
ORACLE = "kernels/ref.py jnp oracle: the kernel's plain twin"
HLO = ("hlo_cost parses compiled HLO text: op_cost counts the ops at "
       "dispatch on the meta device")
GSPMD = "GSPMD sharding only: the port runs each step on one device"
UNCALLED = "never called by the reference"
RENAMED = "done under another name"
MEASURED = ("measured by the benchmark's chat cell and the serve.decode "
            "span")
SHARED = ("shared with the kernels' plain twins: defined below both, "
          "imported into models/layers.py")

# "module.py" (a whole module with no port file) or "module.py:name" ->
# (reason, counterpart): "port_module.py:name", a file under the port, or
# None.
NO_COUNTERPART = {
    "kernels/ref.py": (ORACLE, None),
    "launch/hlo_cost.py": (HLO, "launch/op_cost.py"),

    "kernels/checksum.py:_checksum_kernel":
        (PALLAS, "kernels/csrc/checksum.cu"),
    "kernels/checksum.py:checksum_words_pallas":
        (PALLAS, "kernels/checksum.py:checksum"),
    "kernels/flash_attention.py:_bwd_dkv_kernel":
        (PALLAS, "kernels/csrc/flash_bwd.cu"),
    "kernels/flash_attention.py:_bwd_dq_kernel":
        (PALLAS, "kernels/csrc/flash_bwd.cu"),
    "kernels/flash_attention.py:_fwd_kernel":
        (PALLAS, "kernels/csrc/flash_fwd.cu"),
    "kernels/flash_attention.py:_mask_block":
        (PALLAS, "kernels/flash_attention.py:_allow"),
    "kernels/flash_attention.py:flash_bwd_pallas":
        (PALLAS, "kernels/flash_attention.py:flash_bwd"),
    "kernels/flash_attention.py:flash_fwd_pallas":
        (PALLAS, "kernels/flash_attention.py:flash_fwd"),
    "kernels/quantize.py:_dequant_kernel":
        (PALLAS, "kernels/csrc/quantize.cu"),
    "kernels/quantize.py:_quant_kernel": (PALLAS, "kernels/csrc/quantize.cu"),
    "kernels/quantize.py:dequantize_pallas":
        (PALLAS, "kernels/quantize.py:dequantize"),
    "kernels/quantize.py:quantize_pallas":
        (PALLAS, "kernels/quantize.py:quantize"),
    "kernels/shard_pack.py:_pack_kernel":
        (PALLAS, "kernels/csrc/shard_pack.cu"),
    "kernels/shard_pack.py:shard_pack_pallas":
        (PALLAS, "kernels/shard_pack.py:shard_pack"),
    "kernels/shard_pack.py:shard_unpack_pallas":
        (PALLAS, "kernels/shard_pack.py:shard_unpack"),
    "kernels/ops.py:_interpret": (PALLAS, None),
    "kernels/ops.py:_pad_d": (PALLAS, None),
    "kernels/ops.py:_checksum_words_device":
        (RENAMED, "kernels/checksum.py:checksum"),
    "kernels/ops.py:_weights_tile": (RENAMED, "kernels/checksum.py:_weights"),
    "kernels/ops.py:_tile_scales": (RENAMED, "kernels/checksum.py:_weights"),
    "kernels/ops.py:_quant_groups":
        (RENAMED, "kernels/quantize.py:quantize_op"),
    "kernels/ops.py:_dequant_groups":
        (RENAMED, "kernels/quantize.py:dequantize_op"),
    "kernels/ops.py:pallas_flash_attention":
        (RENAMED, "kernels/ops.py:flash_attention"),
    "kernels/ops.py:_to_kernel_layout": (RENAMED, "kernels/ops.py:_five_d"),
    "kernels/ops.py:_pallas_flash_fwd":
        (RENAMED, "kernels/ops.py:_FlashAttention"),
    "kernels/ops.py:_pallas_flash_bwd":
        (RENAMED, "kernels/ops.py:_FlashAttention"),

    "kernels/ref.py:bytes_to_words": (ORACLE, "kernels/checksum.py:byte_view"),
    "kernels/ref.py:weight_powers": (ORACLE, "kernels/checksum.py:_weights"),
    "kernels/ref.py:checksum_words":
        (ORACLE, "kernels/checksum.py:checksum_reference"),
    "kernels/ref.py:quantize_int8":
        (ORACLE, "kernels/quantize.py:quantize_reference"),
    "kernels/ref.py:dequantize_int8":
        (ORACLE, "kernels/quantize.py:dequantize_reference"),
    "kernels/ref.py:shard_pack":
        (ORACLE, "kernels/shard_pack.py:shard_pack_reference"),
    "kernels/ref.py:shard_unpack":
        (ORACLE, "kernels/shard_pack.py:shard_unpack_reference"),

    "launch/hlo_cost.py:analyze": (HLO, "launch/op_cost.py:OpCost"),
    "launch/hlo_cost.py:_type_bytes": (HLO, "launch/op_cost.py:tensor_bytes"),
    "launch/hlo_cost.py:_type_elems": (HLO, None),
    "launch/hlo_cost.py:Op": (HLO, None),
    "launch/hlo_cost.py:Computation": (HLO, None),
    "launch/hlo_cost.py:parse_module": (HLO, None),
    "launch/hlo_cost.py:_trip_count": (HLO, None),
    "launch/hlo_cost.py:_callees": (HLO, None),
    "launch/hlo_cost.py:_multipliers": (HLO, None),
    "launch/hlo_cost.py:_dot_flops": (HLO, None),
    "launch/hlo_cost.py:_conv_flops": (HLO, None),
    "launch/hlo_cost.py:_op_hbm_bytes": (HLO, None),
    "launch/hlo_cost.py:_group_size": (HLO, None),

    "launch/dryrun.py:_sds_with_sharding": (GSPMD, None),
    "launch/mesh.py:mesh_axes": (GSPMD, None),
    "models/layers.py:set_activation_sharding": (GSPMD, None),

    "models/layers.py:attention_full": (UNCALLED, None),
    "models/layers.py:_rms_norm_bf16": (UNCALLED, None),
    "models/layers.py:_rms_fwd": (UNCALLED, None),
    "models/layers.py:_rms_bwd": (UNCALLED, None),
    "models/layers.py:rope_freqs":
        (SHARED, "kernels/attention_math.py:rope_freqs"),
    "models/layers.py:gqa_scores_softmax_v":
        (SHARED, "kernels/attention_math.py:gqa_scores_softmax_v"),

    "models/attention_flash.py:_attend_block":
        (RENAMED, "models/attention_flash.py:_scores"),
    "models/attention_flash_vjp.py:_expand_q":
        (RENAMED, "models/attention_flash_vjp.py:_heads"),
    "models/attention_flash_vjp.py:_flash_fwd":
        (RENAMED, "models/attention_flash_vjp.py:_FlashCVJP"),
    "models/attention_flash_vjp.py:_flash_fwd_impl":
        (RENAMED, "models/attention_flash_vjp.py:_forward"),
    "models/attention_flash_vjp.py:_flash_fwd_body":
        (RENAMED, "models/attention_flash_vjp.py:_forward"),
    "models/attention_flash_vjp.py:_flash_bwd":
        (RENAMED, "models/attention_flash_vjp.py:_FlashCVJP"),
    "models/attention_flash_vjp.py:_flash_bwd_body":
        (RENAMED, "models/attention_flash_vjp.py:_backward"),
    "models/model.py:_act_dtype": (RENAMED, "models/layers.py:_dtype"),
    "models/moe.py:_expert_ffn": (RENAMED, "models/moe.py:expert_ffn"),
    "models/moe.py:_expert_ffn_fwd": (RENAMED, "models/moe.py:_ExpertFFN"),
    "models/moe.py:_expert_ffn_bwd": (RENAMED, "models/moe.py:_ExpertFFN"),
    "models/transformer.py:_scan_stack":
        (RENAMED, "models/transformer.py:_run_bodies"),
    "models/transformer.py:_hybrid_full":
        (RENAMED, "models/transformer.py:forward_train"),
    "models/transformer.py:_encdec_train":
        (RENAMED, "models/transformer.py:forward_train"),
    "models/transformer.py:param_shapes":
        (RENAMED, "models/model.py:param_shapes"),

    "serve/serve_step.py:measure_decode_s": (MEASURED, "spans.py:span"),
}


class Kernel(NamedTuple):
    source: str        # under the port's kernels/csrc/
    module: str        # repro_torch.kernels.<module>
    wrapper: str       # launches the kernel on CUDA, the twin on the CPU
    counter: str       # module global the wrapper adds one to per launch
    twin: str          # the plain PyTorch version
    smoke_key: str     # chip_smoke._counters()'s key for the counter


# "module.py:function#i": the i-th pallas_call in that top-level function.
KERNELS = {
    "kernels/flash_attention.py:flash_fwd_pallas#0": Kernel(
        "flash_fwd.cu", "flash_attention", "flash_fwd", "LAUNCHES",
        "flash_fwd_reference", "flash_fwd"),
    "kernels/flash_attention.py:flash_bwd_pallas#0": Kernel(
        "flash_bwd.cu", "flash_attention", "flash_bwd", "BWD_DQ_LAUNCHES",
        "flash_bwd_reference", "flash_bwd_dq"),
    "kernels/flash_attention.py:flash_bwd_pallas#1": Kernel(
        "flash_bwd.cu", "flash_attention", "flash_bwd", "BWD_DKV_LAUNCHES",
        "flash_bwd_reference", "flash_bwd_dkv"),
    "kernels/quantize.py:quantize_pallas#0": Kernel(
        "quantize.cu", "quantize", "quantize", "QUANT_LAUNCHES",
        "quantize_reference", "quantize"),
    "kernels/quantize.py:dequantize_pallas#0": Kernel(
        "quantize.cu", "quantize", "dequantize", "DEQUANT_LAUNCHES",
        "dequantize_reference", "dequantize"),
    "kernels/checksum.py:checksum_words_pallas#0": Kernel(
        "checksum.cu", "checksum", "checksum", "CHECKSUM_LAUNCHES",
        "checksum_reference", "checksum"),
    "kernels/shard_pack.py:shard_pack_pallas#0": Kernel(
        "shard_pack.cu", "shard_pack", "shard_pack", "PACK_LAUNCHES",
        "shard_pack_reference", "shard_pack"),
    "kernels/shard_pack.py:shard_unpack_pallas#0": Kernel(
        "shard_pack.cu", "shard_pack", "shard_unpack", "UNPACK_LAUNCHES",
        "shard_unpack_reference", "shard_unpack"),
}


# ------------------------------- helpers -------------------------------

def modules(root: pathlib.Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def top_level_defs(path: pathlib.Path, assigned: bool = False) -> set[str]:
    """Top-level defs and classes of a module; with ``assigned``, the
    names it assigns at top level too."""
    names = set()
    for n in _tree(path).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif assigned and isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


def counterpart_exists(port: pathlib.Path, target: str) -> bool:
    module, _, name = target.partition(":")
    path = port / module
    return path.is_file() and (
        not name or name in top_level_defs(path, assigned=True))


def missing_names(ref: pathlib.Path, port: pathlib.Path, module: str,
                  table: dict) -> list[str]:
    """What the port lacks of one reference module: "module.py" if it has
    no such file and the table does not say so, and each "module.py:name"
    it does not define and the table does not list."""
    names = top_level_defs(ref / module)
    out = []
    if (port / module).is_file():
        names -= top_level_defs(port / module, assigned=True)
    elif module not in table:
        out.append(module)
    return out + sorted(f"{module}:{n}" for n in names
                        if f"{module}:{n}" not in table)


def stale_entries(ref: pathlib.Path, port: pathlib.Path,
                  table: dict) -> list[str]:
    """Entries that no longer fit: the reference has no such module or
    name, the port has the module or name after all, or the counterpart
    named does not exist."""
    out = []
    for key, (_reason, target) in sorted(table.items()):
        module, _, name = key.partition(":")
        if not (ref / module).is_file() or (
                name and name not in top_level_defs(ref / module)):
            out.append(f"{key}: not in the reference")
        elif (port / module).is_file() and (
                not name
                or name in top_level_defs(port / module, assigned=True)):
            out.append(f"{key}: the port has it")
        if target is not None and not counterpart_exists(port, target):
            out.append(f"{key}: counterpart {target} missing")
    return out


def pallas_sites(ref: pathlib.Path) -> list[str]:
    """"module.py:function#i" for every pallas_call, i counting the calls
    within one top-level function in source order."""
    sites = []
    for module in modules(ref):
        for top in _tree(ref / module).body:
            calls = sorted(
                (n for n in ast.walk(top) if isinstance(n, ast.Call)
                 and getattr(n.func, "attr", getattr(n.func, "id", None))
                 == "pallas_call"),
                key=lambda n: (n.lineno, n.col_offset))
            name = getattr(top, "name", "<module>")
            sites += [f"{module}:{name}#{i}" for i in range(len(calls))]
    return sites


def site_faults(ref: pathlib.Path, kernels: dict) -> list[str]:
    """Pallas sites with no kernel row, and rows with no site."""
    sites = pallas_sites(ref)
    return ([f"{s}: no kernel" for s in sites if s not in kernels]
            + [f"{s}: not in the reference" for s in kernels
               if s not in sites])


def smoke_counters(smoke: pathlib.Path) -> dict[str, str]:
    """chip_smoke.py's ``_counters()`` as {key: "module.COUNTER"}, read
    from its source."""
    fn = next(n for n in _tree(smoke).body
              if isinstance(n, ast.FunctionDef) and n.name == "_counters")
    alias = {a.asname or a.name: a.name for n in fn.body
             if isinstance(n, ast.ImportFrom)
             and n.module == "repro_torch.kernels" for a in n.names}
    ret = next(n for n in fn.body if isinstance(n, ast.Return))
    return {k.value: f"{alias[v.value.id]}.{v.attr}"
            for k, v in zip(ret.value.keys, ret.value.values)}


def kernel_faults(port: pathlib.Path, smoke: pathlib.Path,
                  k: Kernel) -> list[str]:
    """What one kernel's port lacks, read from source: its CUDA file with a
    ``__global__`` kernel, a wrapper that calls the twin and adds one to
    the counter, the twin itself, and chip_smoke.py reading the counter."""
    out = []
    cu = port / "kernels" / "csrc" / k.source
    if not cu.is_file() or "__global__" not in cu.read_text():
        out.append(f"no CUDA kernel in {cu.name}")
    mod = port / "kernels" / f"{k.module}.py"
    tops = {n.name: n for n in _tree(mod).body
            if isinstance(n, ast.FunctionDef)} if mod.is_file() else {}
    if k.twin not in tops:
        out.append(f"no twin {k.twin}")
    wrapper = tops.get(k.wrapper)
    if wrapper is None:
        out.append(f"no wrapper {k.wrapper}")
    else:
        nodes = list(ast.walk(wrapper))
        if not any(isinstance(n, ast.Call)
                   and getattr(n.func, "id", None) == k.twin for n in nodes):
            out.append(f"{k.wrapper} never calls {k.twin}")
        if not any(isinstance(n, ast.AugAssign)
                   and getattr(n.target, "id", None) == k.counter
                   for n in nodes):
            out.append(f"{k.wrapper} never counts {k.counter}")
    if smoke_counters(smoke).get(k.smoke_key) != f"{k.module}.{k.counter}":
        out.append(f"chip_smoke _counters() lacks {k.smoke_key}")
    return out


# -------------------------------- the tree --------------------------------

@pytest.mark.parametrize("module", modules(REF))
def test_port_defines_every_reference_name(module):
    assert missing_names(REF, PORT, module, NO_COUNTERPART) == []


def test_no_counterpart_table_matches_the_reference():
    assert stale_entries(REF, PORT, NO_COUNTERPART) == []
    assert {r for r, _ in NO_COUNTERPART.values()} \
        == {PALLAS, ORACLE, HLO, GSPMD, UNCALLED, RENAMED, MEASURED, SHARED}


def test_every_pallas_call_has_a_kernel():
    assert len(pallas_sites(REF)) == 8
    assert site_faults(REF, KERNELS) == []


@pytest.mark.parametrize("site", sorted(KERNELS))
def test_kernel_is_ported_counted_and_smoked(site):
    k = KERNELS[site]
    assert kernel_faults(PORT, CHIP_SMOKE, k) == []
    mod = importlib.import_module(f"repro_torch.kernels.{k.module}")
    assert callable(getattr(mod, k.wrapper))
    assert callable(getattr(mod, k.twin))
    assert isinstance(getattr(mod, k.counter), int)


# ----------------------------- negative cases -----------------------------

def _write(root: pathlib.Path, rel: str, text: str) -> None:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


REF_SRC = '''
from jax.experimental import pallas as pl

def kept(x):
    return x

def fresh(x):
    return x

def kept_pallas(x):
    return pl.pallas_call(kept, grid=(1,))(x)

def fresh_pallas(x):
    y = pl.pallas_call(kept, grid=(1,))(x)
    return pl.pallas_call(kept, grid=(1,))(y)
'''


@pytest.fixture()
def roots(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    _write(ref, "kernels/new.py", REF_SRC)
    _write(port, "kernels/new.py", "def kept(x):\n    return x\n")
    return ref, port


def test_names_check_fails_on_an_unmapped_function(roots):
    ref, port = roots
    table = {"kernels/new.py:fresh_pallas": (PALLAS, None),
             "kernels/new.py:kept_pallas": (PALLAS, None)}
    assert missing_names(ref, port, "kernels/new.py", table) \
        == ["kernels/new.py:fresh"]
    (port / "kernels/new.py").unlink()
    assert missing_names(ref, port, "kernels/new.py", table) \
        == ["kernels/new.py", "kernels/new.py:fresh", "kernels/new.py:kept"]


def test_table_check_fails_on_a_stale_entry(roots):
    ref, port = roots
    table = {"kernels/new.py:gone": (UNCALLED, None),
             "kernels/new.py:kept": (RENAMED, None),
             "kernels/new.py:fresh": (RENAMED, "kernels/new.py:absent"),
             "kernels/new.py:fresh_pallas": (PALLAS, "kernels/csrc/new.cu"),
             "kernels/old.py": (ORACLE, None)}
    assert stale_entries(ref, port, table) == [
        "kernels/new.py:fresh: counterpart kernels/new.py:absent missing",
        "kernels/new.py:fresh_pallas: counterpart kernels/csrc/new.cu "
        "missing",
        "kernels/new.py:gone: not in the reference",
        "kernels/new.py:kept: the port has it",
        "kernels/old.py: not in the reference"]


def test_kernel_check_fails_on_an_unmapped_pallas_call(roots):
    ref, _ = roots
    assert pallas_sites(ref) == ["kernels/new.py:kept_pallas#0",
                                 "kernels/new.py:fresh_pallas#0",
                                 "kernels/new.py:fresh_pallas#1"]
    row = KERNELS["kernels/shard_pack.py:shard_pack_pallas#0"]
    kernels = {"kernels/new.py:kept_pallas#0": row,
               "kernels/new.py:fresh_pallas#0": row,
               "kernels/new.py:gone_pallas#0": row}
    assert site_faults(ref, kernels) == [
        "kernels/new.py:fresh_pallas#1: no kernel",
        "kernels/new.py:gone_pallas#0: not in the reference"]


def test_kernel_check_fails_on_a_kernel_without_its_port(roots, tmp_path):
    _, port = roots
    smoke = tmp_path / "chip_smoke.py"
    smoke.write_text("def _counters():\n"
                     "    from repro_torch.kernels import new as nw\n"
                     "    return {'new': nw.OTHER}\n")
    _write(port, "kernels/csrc/new.cu", "// no kernel yet\n")
    _write(port, "kernels/new.py", "NEW_LAUNCHES = 0\n\n"
           "def new_reference(x):\n    return x\n\n"
           "def new(x):\n    return x\n")
    k = Kernel("new.cu", "new", "new", "NEW_LAUNCHES", "new_reference",
               "new")
    assert kernel_faults(port, smoke, k) == [
        "no CUDA kernel in new.cu", "new never calls new_reference",
        "new never counts NEW_LAUNCHES", "chip_smoke _counters() lacks new"]
