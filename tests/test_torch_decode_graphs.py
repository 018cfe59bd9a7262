"""``models.decode.DecodeGraphs`` on the CPU, where no CUDA graph exists: a
stand-in graph records, while it captures, each layer's call (its function,
static input and output) and repeats them at replay into the same output,
leaving the caches and counters as a capture and a replay on the card leave
them.  The step's bookkeeping is then held against the op-by-op step, bit
for bit, at smoke size: the static buffers chained from layer to layer, the
position read from its device tensor (a replay at a later position than
the capture's), the key (a new cache, a new split plan, each captured
once), the call counters a replay advances and the spans it opens, and
which steps the graphs serve.  The card's own graphs are held to the same
bits by ``tests/test_torch_kernels_gpu.py``."""
import contextlib
import dataclasses

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.kernels import decode_attention as da
from repro_torch.models import forward_decode, init_model
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.serve import make_prefill_step


class _Graph:
    """A CUDA graph's stand-in: between ``capture_begin`` and
    ``capture_end`` the layers' calls are recorded (by ``stand_in``'s
    ``_layers``), and ``replay`` repeats them into their static outputs."""
    recording = None

    def __init__(self):
        self.calls = []

    def capture_begin(self, pool=None):
        _Graph.recording = self

    def capture_end(self):
        _Graph.recording = None

    def replay(self):
        """The calls again, with their spans and counters quiet (a graph's
        replay runs kernels alone; ``run`` opens the span and counts)."""
        before = D._calls()
        mods = (L, T, D)
        real = [m.span for m in mods]
        for m in mods:
            m.span = lambda name: spans._OFF
        try:
            for fn, inp, out in self.calls:
                out.copy_(fn(inp))
        finally:
            for m, s in zip(mods, real):
                m.span = s
        D._advance({k: before[k] - n for k, n in D._calls().items()})


@pytest.fixture
def stand_in(monkeypatch):
    """torch.cuda's graph calls replaced by ``_Graph`` and no-ops; a capture
    leaves the cache as it found it, as a capture that runs nothing does."""
    real_layers, real_capture = D._layers, D.DecodeGraphs._capture

    def layers(*args, **kwargs):
        def rec(fn):
            def call(x):
                y = fn(x)
                if _Graph.recording is not None:
                    _Graph.recording.calls.append((fn, x, y))
                return y
            return call
        return [(name, rec(fn))
                for name, fn in real_layers(*args, **kwargs)]

    def capture(self, params, cfg, cache, *args):
        saved = {k: v.clone() for k, v in cache.items()}
        real_capture(self, params, cfg, cache, *args)
        for k, v in cache.items():
            v.copy_(saved[k])

    monkeypatch.setattr(D, "_layers", layers)
    monkeypatch.setattr(D.DecodeGraphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    yield
    spans.reset()


def _model(arch, prompt, pad_to, batch=2):
    cfg = smoke_variant(ARCHS[arch])
    gen = torch.Generator().manual_seed(0)
    params = init_model(gen, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + 8),
                         generator=gen, dtype=torch.int32)
    _, cache = make_prefill_step(cfg, pad_to=pad_to, device="cpu")(
        params, {"tokens": toks[:, :prompt]})
    return cfg, params, toks, cache


def _calls_now():
    return (dict(SSM.SSD_CALLS), dict(M.DROPLESS_CALLS))


# (arch, prompt, cache slots, positions, graph captures, what a step's
# layers count on the CPU: (SSD decode calls, batched MoE calls))
CASES = {
    # a ring of 12 slots: positions 12 .. 15 wrap to slots 0 .. 3
    "dense_ring_wraps": ("deepseek-7b", 8, 12, range(8, 16), 1, (0, 0)),
    # 2 x 4 kv heads: 8 blocks, one split up to 64 valid slots, two from
    # position 64 on: a second capture there
    "dense_plan_changes": ("deepseek-7b", 60, 80, range(60, 68), 2, (0, 0)),
    "ssm_moe": ("granite-4.0-h-small", 8, 14, range(8, 16), 1, (2, 3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_replays_give_the_op_by_op_step(stand_in, case):
    arch, prompt, slots, positions, captures, counts = CASES[case]
    cfg, params, toks, cache_g = _model(arch, prompt, slots)
    cache_e = {k: v.clone() for k, v in cache_g.items()}
    graphs = D.DecodeGraphs()
    captures0, replays0 = D.GRAPH_CAPTURES, D.GRAPH_REPLAYS
    keys = []
    for pos in positions:
        tok = toks[:, pos - positions[0] + prompt:][:, :1]
        replay = graphs.key is not None and graphs.key == graphs._key(
            params, cfg, cache_g, torch.empty(tok.shape[0], 1, cfg.d_model),
            pos, cfg.n_heads)
        calls = _calls_now()
        spans.reset()
        ctx = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) if replay \
            else contextlib.nullcontext()
        with ctx, torch.no_grad():
            x = L.embed(params["embed"], tok, cfg.embedding_multiplier)
            h_g = graphs.run(params, cfg, cache_g, x, pos, cfg.n_heads)
            h_g = h_g.clone()
        now = _calls_now()
        assert (now[0]["decode"] - calls[0]["decode"],
                now[1]["batched"] - calls[1]["batched"]) == counts
        if replay:
            rec = spans.record()
            want = {"decode.attention": cfg.layer_types.count("attention")
                    if cfg.family == "ssm_moe" else cfg.n_layers}
            if cfg.family == "ssm_moe":
                want.update({"decode.ssm": counts[0],
                             "decode.moe": counts[1]})
            assert {k: rec[k]["count"] for k in want} == want
        keys.append(graphs.key)
        with torch.no_grad():
            h_e, cache_e = forward_decode(params, cfg, cache_e, tok, pos)
        assert torch.equal(h_g, h_e), pos
        for k in cache_e:
            assert torch.equal(cache_g[k], cache_e[k]), (pos, k)
    assert D.GRAPH_CAPTURES - captures0 == captures == len(set(keys))
    assert D.GRAPH_REPLAYS - replays0 == len(positions) - captures


def test_a_new_cache_is_captured_anew(stand_in):
    cfg, params, toks, cache = _model("deepseek-7b", 8, 12)
    graphs = D.DecodeGraphs()
    captures0 = D.GRAPH_CAPTURES
    with torch.no_grad():
        for c in (cache, {k: v.clone() for k, v in cache.items()}):
            for pos in (8, 9):
                x = L.embed(params["embed"], toks[:, pos:pos + 1])
                graphs.run(params, cfg, c, x, pos, cfg.n_heads)
    assert D.GRAPH_CAPTURES - captures0 == 2


def test_a_replay_reads_the_position_from_its_tensor(stand_in):
    """The captured attention takes the position from ``graphs.pos``: set
    there (as ``run`` sets it) it moves the rope and the slot written."""
    cfg, params, toks, cache = _model("deepseek-7b", 8, 12)
    graphs = D.DecodeGraphs()
    with torch.no_grad():
        x = L.embed(params["embed"], toks[:, 8:9])
        graphs.run(params, cfg, cache, x, 8, cfg.n_heads)    # captures
        before = cache["k"].clone()
        graphs.x_in.copy_(x)
        graphs.pos.fill_(10)
        for _, graph in graphs.graphs:
            graph.replay()
    changed = (cache["k"] != before).any(dim=(0, 1, 3, 4)).nonzero()
    assert changed.flatten().tolist() == [10]


def test_a_smaller_cache_at_the_same_address_is_captured_anew(stand_in):
    """Two caches of 12 and 11 slots on one storage: the same addresses and
    the same split plan (one split of 64 rows), but other slots and
    strides, which the captured attention holds; the second is captured
    anew and gives the op-by-op step's bits."""
    cfg, params, toks, big = _model("deepseek-7b", 8, 12)
    _, _, _, small = _model("deepseek-7b", 8, 11)
    store = {k: torch.empty(v.numel(), dtype=v.dtype)
             for k, v in big.items()}
    views = []
    for c in (big, small):
        view = {k: store[k][:v.numel()].view(v.shape) for k, v in c.items()}
        views.append((view, c))
    graphs = D.DecodeGraphs()
    captures0 = D.GRAPH_CAPTURES
    with torch.no_grad():
        for view, c in views:
            for k, v in c.items():
                view[k].copy_(v)
            eager = {k: v.clone() for k, v in c.items()}
            for pos in (8, 9, 10):
                tok = toks[:, pos:pos + 1]
                x = L.embed(params["embed"], tok)
                h_g = graphs.run(params, cfg, view, x, pos,
                                 cfg.n_heads).clone()
                h_e, eager = forward_decode(params, cfg, eager, tok, pos)
                assert torch.equal(h_g, h_e), pos
                for k in eager:
                    assert torch.equal(view[k], eager[k]), (pos, k)
    assert views[0][0]["k"].data_ptr() == views[1][0]["k"].data_ptr()
    assert D.GRAPH_CAPTURES - captures0 == 2


@pytest.mark.parametrize("family,rows,want", [
    ("dense", 4096, True), ("vlm", 16, True), ("audio", 16, True),
    ("ssm_moe", 64, True), ("ssm_moe", 65, False),     # the grouped route
    ("moe", 16, False), ("hybrid", 16, False), ("encdec", 16, False),
    ("ssm", 16, False)])
def test_which_steps_the_graphs_serve(family, rows, want):
    cfg = dataclasses.replace(smoke_variant(ARCHS["deepseek-7b"]),
                              family=family)
    assert D.DecodeGraphs.serves(cfg, rows) is want


def test_the_op_takes_its_position_from_the_tensor():
    """The op on the CPU (the twin) given ``pos_dev`` computes at that
    position: the int path's output and caches at pos_dev's value, and
    another at the host int's."""
    gen = torch.Generator().manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=gen)
    q, k, v = mk(2, 1, 4, 16), mk(2, 1, 2, 16), mk(2, 1, 2, 16)
    ck, cv = mk(2, 10, 2, 16), mk(2, 10, 2, 16)
    for pos in (4, 13):
        a_k, a_v, b_k, b_v = ck.clone(), cv.clone(), ck.clone(), cv.clone()
        got = da.decode_attn_op(q, k, v, a_k, a_v, 0, 1.0, 1e4, False, None,
                                torch.tensor(pos, dtype=torch.int32))
        want = da.decode_attn_op(q, k, v, b_k, b_v, pos, 1.0, 1e4, False)
        assert torch.equal(got, want)
        assert torch.equal(a_k, b_k) and torch.equal(a_v, b_v)
        other = da.decode_attn_op(q, k, v, ck.clone(), cv.clone(), 0, 1.0,
                                  1e4, False)
        assert not torch.equal(got, other)
