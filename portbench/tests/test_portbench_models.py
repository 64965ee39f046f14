"""The model modules (``portbench/models/``) and their loader.

The pinned tests hold ``periodic``, and the harness that goes through it,
to the values the harness gave before the layers moved into model modules
(commit dd7d2b5, the harness of ``portbench/lib/`` alone, on the CPU):
the weights bit for bit per leaf, the reference's logits bit for bit, the
work counts, the slice store's size and ``attn_roofline.decode`` exactly.
The layout tests serve a test-only module (``stub_root/``) whose MoE
layers are not ``n_layers // len(pattern)`` periods."""

import hashlib
import json
import math
import pathlib
import re
import types

import numpy as np
import pytest
import torch

from portbench.lib import bench, loader
from portbench.lib import counts as C
from portbench.lib import serve
from portbench.lib.profile import STEP, Kernel, Trace
from portbench.lib.reference import DecodeContext, RefRequest
from portbench.tests.cells import HERE, QWEN_REPRO, ROOT, TINY_HYBRID

torch.set_num_threads(1)

SMALL = {"qwen15-moe-repro": QWEN_REPRO, "tiny-hybrid": TINY_HYBRID}
FULL = ("qwen15-moe-a2.7b", "jamba-v0.1-52b-8l")
SEEDS = (3, 2 ** 31 + 17)
STUB_ROOT = HERE / "tests" / "stub_root"
FWD = "slicemoe.decode_forward"

LOGITS = {  # (float32 logits, float8 control's logits), flips
    "qwen15-moe-repro": (("dd099e091a19e270", "4de90c480cad32d4"),
                         [4, 4, 4, 4]),
    "tiny-hybrid": (("9664e3cc38a628c8", "bf5be83502c0db8a"), [4, 4, 4, 4]),
}
COUNTS = {  # decode (flops, bytes), prefill (flops, bytes)
    "qwen15-moe-a2.7b": (270364442624.0, 24745254912.0,
                         1223734460416.0, 17559297888.0),
    "jamba-v0.1-52b-8l": (350177853440.0, 16635386176.0,
                          1683545882624.0, 16493732192.0),
}
STORE = {  # store_bytes, slice_bytes
    "qwen15-moe-a2.7b": (13430292480.0, (5001216.0, 4325376.0)),
    "jamba-v0.1-52b-8l": (12155092992.0, (101842944.0, 88080384.0)),
}
ATTN = {
    "qwen15-moe-a2.7b": 85.57916743554954,
    "jamba-v0.1-52b-8l": 1.7828993215739486,
}
WEIGHTS = {
    "qwen15-moe-repro@2147483665": {
        "blocks/pos0/bk": "ad7facb2586fc6e9",
        "blocks/pos0/bq": "ad7facb2586fc6e9",
        "blocks/pos0/bv": "ad7facb2586fc6e9",
        "blocks/pos0/moe/experts/wi": "dd7d62685f959fe5",
        "blocks/pos0/moe/experts/wo": "8c30c49adb3d9a5c",
        "blocks/pos0/moe/shared/wi": "a708df6779be04f7",
        "blocks/pos0/moe/shared/wo": "fcf0b60ea71a4f48",
        "blocks/pos0/moe/w_router": "8516d12b66ad7986",
        "blocks/pos0/moe_norm": "ad7facb2586fc6e9",
        "blocks/pos0/norm": "ad7facb2586fc6e9",
        "blocks/pos0/wk": "1ba705d5e2b1384a",
        "blocks/pos0/wo": "b525fa32447562f4",
        "blocks/pos0/wq": "956f7f3d6e2c9890",
        "blocks/pos0/wv": "199c9f749cf35d80",
        "embed": "7ff3ae226c3cc64b",
        "final_norm": "5f70bf18a0860070",
        "unembed": "7a973b5c4c28176e",
    },
    "qwen15-moe-repro@3": {
        "blocks/pos0/bk": "ad7facb2586fc6e9",
        "blocks/pos0/bq": "ad7facb2586fc6e9",
        "blocks/pos0/bv": "ad7facb2586fc6e9",
        "blocks/pos0/moe/experts/wi": "27bee9a924445d79",
        "blocks/pos0/moe/experts/wo": "63691ea995bf43a6",
        "blocks/pos0/moe/shared/wi": "f0fc176e5afcca39",
        "blocks/pos0/moe/shared/wo": "25951b51731dc2d8",
        "blocks/pos0/moe/w_router": "9c8655c7218f420c",
        "blocks/pos0/moe_norm": "ad7facb2586fc6e9",
        "blocks/pos0/norm": "ad7facb2586fc6e9",
        "blocks/pos0/wk": "c8491fc2ef91a66b",
        "blocks/pos0/wo": "fa0cdb210384c219",
        "blocks/pos0/wq": "996a59b6006d0090",
        "blocks/pos0/wv": "7519efdee83221dd",
        "embed": "32d0fbacd3f44a27",
        "final_norm": "5f70bf18a0860070",
        "unembed": "820702490784cfd7",
    },
    "tiny-hybrid@2147483665": {
        "blocks/pos0/moe/experts/wi": "0a8a520f795847fc",
        "blocks/pos0/moe/experts/wo": "a257ced369ef45fc",
        "blocks/pos0/moe/w_router": "e6850355eec02ac2",
        "blocks/pos0/moe_norm": "5f70bf18a0860070",
        "blocks/pos0/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos0/ssm/D": "9628e545ed3ac074",
        "blocks/pos0/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos0/ssm/conv_w": "49c9cbf76a2d33fd",
        "blocks/pos0/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos0/ssm/in_proj": "061ce2173ada51eb",
        "blocks/pos0/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos0/ssm/out_proj": "3aa475b7e2455661",
        "blocks/pos0/ssm_norm": "5f70bf18a0860070",
        "blocks/pos1/mlp/wi": "39440a56a0be43d0",
        "blocks/pos1/mlp/wo": "4fd47a99ddc2a4a3",
        "blocks/pos1/mlp_norm": "5f70bf18a0860070",
        "blocks/pos1/norm": "5f70bf18a0860070",
        "blocks/pos1/wk": "28c0b5f89fefaefe",
        "blocks/pos1/wo": "fc1b449959f40e42",
        "blocks/pos1/wq": "75113a4f14d4fa40",
        "blocks/pos1/wv": "64f386b3e3718890",
        "blocks/pos2/moe/experts/wi": "2341c3055a2d1ef9",
        "blocks/pos2/moe/experts/wo": "f66337b8d7067d93",
        "blocks/pos2/moe/w_router": "8a82be2d177c6562",
        "blocks/pos2/moe_norm": "5f70bf18a0860070",
        "blocks/pos2/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos2/ssm/D": "9628e545ed3ac074",
        "blocks/pos2/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos2/ssm/conv_w": "a950a47a940b94a6",
        "blocks/pos2/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos2/ssm/in_proj": "c4f6b4606af58a7a",
        "blocks/pos2/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos2/ssm/out_proj": "e4af0d2862d30c9f",
        "blocks/pos2/ssm_norm": "5f70bf18a0860070",
        "blocks/pos3/mlp/wi": "36bacb93d5fcf5fb",
        "blocks/pos3/mlp/wo": "c09cea52ba4a1a90",
        "blocks/pos3/mlp_norm": "5f70bf18a0860070",
        "blocks/pos3/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos3/ssm/D": "9628e545ed3ac074",
        "blocks/pos3/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos3/ssm/conv_w": "3f4fed5db69988d3",
        "blocks/pos3/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos3/ssm/in_proj": "0decc700c3db0160",
        "blocks/pos3/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos3/ssm/out_proj": "c430c2c52a40674c",
        "blocks/pos3/ssm_norm": "5f70bf18a0860070",
        "embed": "2a90007c817205e2",
        "final_norm": "076a27c79e5ace2a",
        "unembed": "6fbdc7fe60ba0c5c",
    },
    "tiny-hybrid@3": {
        "blocks/pos0/moe/experts/wi": "6aa2e3d1f637385d",
        "blocks/pos0/moe/experts/wo": "998d6a3940f66fc0",
        "blocks/pos0/moe/w_router": "0a80fa267a35587d",
        "blocks/pos0/moe_norm": "5f70bf18a0860070",
        "blocks/pos0/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos0/ssm/D": "9628e545ed3ac074",
        "blocks/pos0/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos0/ssm/conv_w": "fd0ec96c5abe5e93",
        "blocks/pos0/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos0/ssm/in_proj": "e68df9614f31e9b0",
        "blocks/pos0/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos0/ssm/out_proj": "3d404149b77079e5",
        "blocks/pos0/ssm_norm": "5f70bf18a0860070",
        "blocks/pos1/mlp/wi": "0ead78eb5eb80aa0",
        "blocks/pos1/mlp/wo": "88e625fd2e2a8a97",
        "blocks/pos1/mlp_norm": "5f70bf18a0860070",
        "blocks/pos1/norm": "5f70bf18a0860070",
        "blocks/pos1/wk": "2cb591b4741e031b",
        "blocks/pos1/wo": "35042cd7d277f647",
        "blocks/pos1/wq": "e4baa8b141150403",
        "blocks/pos1/wv": "acb9091f01e77e8b",
        "blocks/pos2/moe/experts/wi": "9e563cccb8fa2790",
        "blocks/pos2/moe/experts/wo": "f68aaa43ee50a4f2",
        "blocks/pos2/moe/w_router": "31acceebf2f78d56",
        "blocks/pos2/moe_norm": "5f70bf18a0860070",
        "blocks/pos2/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos2/ssm/D": "9628e545ed3ac074",
        "blocks/pos2/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos2/ssm/conv_w": "ffccb51fe43699eb",
        "blocks/pos2/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos2/ssm/in_proj": "4c1dbccec0213bc4",
        "blocks/pos2/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos2/ssm/out_proj": "7186e97fb487c76e",
        "blocks/pos2/ssm_norm": "5f70bf18a0860070",
        "blocks/pos3/mlp/wi": "8f2c2ff5849b1044",
        "blocks/pos3/mlp/wo": "7959a3e2a20db17b",
        "blocks/pos3/mlp_norm": "5f70bf18a0860070",
        "blocks/pos3/ssm/A_log": "c7a7a31e31059a04",
        "blocks/pos3/ssm/D": "9628e545ed3ac074",
        "blocks/pos3/ssm/conv_b": "cfc335996cfae29f",
        "blocks/pos3/ssm/conv_w": "8ab7a7aa06400092",
        "blocks/pos3/ssm/dt_bias": "2994705b78476aa6",
        "blocks/pos3/ssm/in_proj": "f9e0d8b69624d752",
        "blocks/pos3/ssm/norm_scale": "e5a00aa9991ac8a5",
        "blocks/pos3/ssm/out_proj": "e631adc3db51b470",
        "blocks/pos3/ssm_norm": "5f70bf18a0860070",
        "embed": "99dad674141a4d58",
        "final_norm": "076a27c79e5ace2a",
        "unembed": "fd7585fede10e677",
    },
}


def _full(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def _engine():
    with open(ROOT / "portbench" / "configs" / "engine.json") as f:
        return json.load(f)


def _sha(t):
    a = t.detach().cpu().contiguous()
    return hashlib.sha256(a.view(torch.uint8).numpy().tobytes()
                          ).hexdigest()[:16]


def _leaves(tree, pre=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def fixed_request(cfg, layout, seed=5):
    """A request of 11 prompt tokens and 4 fed ones, each decode step in a
    batch of 3 with random routing records."""
    rng = np.random.default_rng(seed)
    V, E, k = cfg["vocab_size"], cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
    S, n, T = 11, 4, 3
    prompt = rng.integers(0, V, S)
    fed = rng.integers(0, V, n)
    n_lay = math.prod(layout)
    ctxs = []
    for j in range(n):
        ids = np.stack([rng.permutation(E)[:k] for _ in range(n_lay * T)])
        ctxs.append(DecodeContext(
            cached=rng.random(layout + (E,)) < 0.5,
            alpha=float(np.float32(3.0 * rng.random())),
            ids=ids.reshape(layout + (T, k)),
            active=rng.random(layout + (T, k)) < 0.9,
            critical=rng.random(layout + (T, k)) < 0.5,
            slot_mask=np.array([True, True, False]), slot=j % 2))
    return RefRequest(prompt, fed, ctxs)


def fixed_routing(layout, E, k, T, seed):
    rng = np.random.default_rng(seed)
    n_lay = math.prod(layout)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(n_lay * T)])
    ids = ids.reshape(layout + (T, k))
    active = rng.random(ids.shape) < 0.95
    critical = rng.random(ids.shape) < 0.4
    mask = rng.random(T) < 0.9
    kv = rng.integers(16, 1537, T)
    return ids, active, critical, mask, kv


def _run(cfg, model, decodes=(), prefills=(), trace=None, traced=(0, 0)):
    cell = types.SimpleNamespace(cfg=cfg, model=model, engine=_engine())
    return bench.Run(cell=cell, seconds=1.0, setup_s=1.0, t_open=0.0,
                     t_close=1.0, d_open=0, d_close=len(decodes),
                     step_end=[], wall_step_s=[], wall_prefill_s=[],
                     decodes=list(decodes), prefills=list(prefills),
                     trace=trace, traced_decodes=traced)


# ----------------------------------------------------------------- pinned
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SMALL))
def test_weights_are_the_parents_bit_for_bit(name, seed):
    cfg = SMALL[name]
    w = loader.model_module(cfg).make_weights(cfg, seed,
                                              torch.device("cpu"))
    assert {p: _sha(t) for p, t in _leaves(w)} == WEIGHTS[f"{name}@{seed}"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_reference_logits_are_the_parents_bit_for_bit(name):
    cfg = SMALL[name]
    model = loader.model_module(cfg)
    w = model.make_weights(cfg, SEEDS[0], torch.device("cpu"))
    req = fixed_request(cfg, tuple(model.moe_layout(cfg)))
    flips = np.zeros(len(req.fed), np.int64)
    logits = model.served_logits(cfg, w, req, theta=0.5, flips=flips)
    low = model.served_logits(cfg, w, req, theta=0.5, fp8=True)
    (want, want_low), want_flips = LOGITS[name]
    assert (_sha(logits), _sha(low)) == (want, want_low)
    assert flips.tolist() == want_flips


@pytest.mark.parametrize("name", FULL)
def test_work_counts_are_the_parents_exactly(name):
    cfg = _full(name)
    layout = tuple(loader.model_module(cfg).moe_layout(cfg))
    E, k = cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
    ids, act, crit, mask, kv = fixed_routing(layout, E, k, 64, 11)
    dw = C.decode_work(cfg, ids, act, crit, mask, kv[mask].tolist())
    pids, pact, _, _, _ = fixed_routing(layout, E, k, 300, 12)
    pw = C.prefill_work(cfg, pids, pact, 300)
    assert (dw.flops, dw.bytes, pw.flops, pw.bytes) == COUNTS[name]


@pytest.mark.parametrize("name", FULL)
def test_store_and_slice_bytes_are_the_parents(name):
    cfg, engine = _full(name), _engine()
    assert (serve.store_bytes(cfg, engine),
            serve.slice_bytes(cfg, engine)) == STORE[name]


@pytest.mark.parametrize("name", FULL)
def test_attn_roofline_reading_is_the_parents(name):
    cfg = _full(name)
    decodes = [types.SimpleNamespace(slots={0: (1, 100), 1: (2, 300)}),
               types.SimpleNamespace(slots={0: (1, 101), 1: (2, 301)})]
    split = "void (anonymous namespace)::decode_attn_split_kernel<128, 4>"
    ops = [Kernel(split, 10.0, 30.0, FWD, launch_us=5.0),
           Kernel(split, 510.0, 25.0, FWD, launch_us=505.0)]
    trace = Trace(window_s=1e-3, ops=ops,
                  ranges={FWD: [(0.0, 400.0), (500.0, 900.0)],
                          STEP: [(0.0, 450.0), (500.0, 1000.0)]},
                  t0_us=0.0, t1_us=1000.0)
    run = _run(cfg, loader.model_module(cfg), decodes, trace=trace,
               traced=(0, 2))
    assert bench.metric_reader("attn_roofline.decode")(run) == ATTN[name]


def test_no_harness_file_reads_a_configurations_layers():
    read = re.compile(r'\["(pattern|n_kv_heads|head_dim|ssm)"\]')
    found = [f"{p.relative_to(ROOT)}:{i}"
             for d in ("lib", "metrics") for p in sorted((HERE / d).glob(
                 "*.py"))
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if read.search(line)]
    assert found == []


# ------------------------------------------------------ layout and loader
STUB = dict(QWEN_REPRO, name="lead-dense", model="lead_dense",
            moe=dict(QWEN_REPRO["moe"], n_experts=6, top_k=2,
                     capacity_factor=100.0))


@pytest.fixture
def stub():
    return loader.model_module(STUB, root=STUB_ROOT)


def test_store_bytes_follow_the_modules_layout(stub):
    engine = _engine()
    per_expert = sum(serve.slice_bytes(STUB, engine))
    assert serve.store_bytes(STUB, engine, stub) == per_expert * 3 * 6
    # Without the module, the name is looked for under the checkout's
    # root, which has no such module.
    with pytest.raises(FileNotFoundError, match="lead-dense"):
        serve.store_bytes(STUB, engine)


def _served(cfg, model, n_moe, seed=4):
    """A run of one request (prompt of 5, 3 tokens served) in a batch of
    2, its residency recorded flat over the MoE layers as the engine
    keeps it."""
    rng = np.random.default_rng(seed)
    E, k = cfg["moe"]["n_experts"], cfg["moe"]["top_k"]
    layout = tuple(model.moe_layout(cfg))
    toks = [7, 8, 9]
    decodes = []
    for j, tok in enumerate([6] + toks[:-1]):
        ids = np.stack([rng.permutation(E)[:k]
                        for _ in range(n_moe * 2)]).reshape(layout + (2, k))
        decodes.append(types.SimpleNamespace(
            slots={1: (0, 6 + j)}, token=np.array([0, tok]),
            cached=rng.random((n_moe, E)) < 0.5, alpha=0.5, ids=ids,
            active=np.ones(ids.shape, bool), critical=ids > 2,
            slot_mask=np.array([False, True])))
    prefill = types.SimpleNamespace(request_id=0, step=0, t0=np.array([6]))
    run = _run(cfg, model, decodes, [prefill])
    loop = types.SimpleNamespace(prompts={0: np.arange(5)}, max_new={0: 3},
                                 finished={0: (2, toks)})
    return bench.Served(run, loop), decodes, layout


@pytest.mark.parametrize("which", ["stub", "periodic"])
def test_ref_request_reshapes_residency_by_the_modules_layout(stub, which):
    # Three periods of tiny-hybrid's pattern: 3 x 2 MoE layers.
    cfg = STUB if which == "stub" else dict(TINY_HYBRID, n_layers=12)
    model = stub if which == "stub" else loader.model_module(cfg)
    n_moe = 3 if which == "stub" else 6
    served, decodes, layout = _served(cfg, model, n_moe)
    assert layout == ((3,) if which == "stub" else (3, 2))
    req, chosen, why = served.ref_request(0)
    assert why is None and chosen.tolist() == [6, 7, 8, 9]
    assert req.fed.tolist() == [6, 7, 8]
    for ctx, rec in zip(req.contexts, decodes):
        assert ctx.cached.shape == layout + (cfg["moe"]["n_experts"],)
        # Layer i of the engine's records is the i-th index of the layout.
        for i, at in enumerate(np.ndindex(*layout)):
            assert np.array_equal(ctx.cached[at], rec.cached[i])
            assert ctx.ids[at].shape == (2, cfg["moe"]["top_k"])


def test_expert_counts_follow_the_modules_layout(stub):
    E, k, T = 6, 2, 5
    ids, act, crit, mask, kv = fixed_routing((3,), E, k, T, 21)
    run = _run(STUB, stub, [types.SimpleNamespace(
        ids=ids, active=act, critical=crit, slot_mask=mask,
        slots={b: (b, int(kv[b])) for b in range(T) if mask[b]})])
    L = stub.layer_work(STUB)
    d, V, B = STUB["d_model"], STUB["vocab_size"], int(mask.sum())
    ctx = float(kv[mask].sum())
    dec = C.Work(2.0 * B * (L.mm + d * V) + L.attn_flops_row * ctx,
                 L.weight_bytes + d * V * 2 + B * d * 2 + B * V * 4
                 + L.kv_bytes_row * (ctx + B))
    pre = C.Work(2.0 * T * L.mm + 2.0 * d * V
                 + L.attn_flops_row * T * (T + 1) / 2,
                 L.weight_bytes + d * V * 2 + T * d * 2 + T * 8 + V * 4
                 + L.kv_bytes_row * T)
    # By hand: each of the layout's 3 MoE layers on its own.
    for layer in range(3):
        one = (ids[layer][None], act[layer][None])
        for w, rows, high in (
                (dec, C.expert_rows(STUB, *one, mask)[0],
                 C.expert_high(STUB, *one, crit[layer][None], mask)[0]),
                (pre, C.expert_rows(STUB, *one, None)[0],
                 np.ones(E, bool))):
            for K, N in C._matrices(STUB):
                w.flops += 2.0 * float(rows.sum()) * K * N
                w.bytes += C._weights(rows, high, K, N, (8, 4))
    got = run.decode_work(0)
    assert (got.flops, got.bytes) == pytest.approx((dec.flops, dec.bytes),
                                                   rel=1e-12)
    got = C.prefill_work(STUB, ids, act, T, model=stub)
    assert (got.flops, got.bytes) == pytest.approx((pre.flops, pre.bytes),
                                                   rel=1e-12)
    assert C.expert_high(STUB, ids, act, None, None).shape == (3, E)


def _root(tmp_path, cfg: dict) -> pathlib.Path:
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "qwen15-decode-c64", "config": "c",
                       "traffic": "chat-c64", "chips": 1}],
        "configs": [{"name": "c", "file": "cfg.json"}],
        "end_to_end": [], "per_layer": []}))
    return tmp_path


@pytest.mark.parametrize("model, error", [
    (None, KeyError), ("no_such_model", FileNotFoundError),
    ("../periodic", ValueError)])
def test_a_config_that_names_no_module_fails_naming_its_file(
        tmp_path, model, error):
    cfg = {k: v for k, v in _full("qwen15-moe-a2.7b").items()
           if k != "model"}
    if model is not None:
        cfg["model"] = model
    with pytest.raises(error, match="cfg.json"):
        bench.load_cell("qwen15-decode-c64", _root(tmp_path, cfg))


def test_each_benchmark_config_names_its_module():
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = bench.load_cell(w["name"])
        assert cell.model.__name__ == "portbench_model_periodic"
        assert cell.model.moe_layout(cell.cfg) == {
            "qwen15-moe-a2.7b": (24, 1),
            "jamba-v0.1-52b-8l": (1, 4)}[cell.cfg["name"]]
