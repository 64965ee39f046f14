"""The benchmark's model modules (``portbench/models/``) in the tier-1 run.

* The pinned and layout cases of ``portbench/tests/test_portbench_models.py``
  (the harness held to the values it gave before the layers moved into
  model modules; the layout served by a test-only module), collected here
  as they are.
* ``deepseek_v2``: every cell names its module and its layout; the weight
  tree is the program's input format leaf for leaf, with the leading
  layer's vectors zero; the slice store and the work counts follow its 26
  MoE layers; ``mla_roofline.decode`` and ``mla_dispatch_ms.decode`` read
  what they should, and nothing on a program without the kernel or the
  span; the reference's float8 control and its count of routing flips.

The benchmark's package is found from the repository's root, as
``portbench/run.py`` finds it.
"""

import json
import math
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from portbench.lib import bench, loader, serve  # noqa: E402
from portbench.lib import counts as C  # noqa: E402
from portbench.lib.profile import STEP, Kernel, Trace  # noqa: E402
from portbench.tests.test_portbench_models import (  # noqa: E402,F401
    _engine, _run, fixed_request, fixed_routing, stub,
    test_a_config_that_names_no_module_fails_naming_its_file,
    test_attn_roofline_reading_is_the_parents,
    test_expert_counts_follow_the_modules_layout,
    test_no_harness_file_reads_a_configurations_layers,
    test_ref_request_reshapes_residency_by_the_modules_layout,
    test_reference_logits_are_the_parents_bit_for_bit,
    test_store_and_slice_bytes_are_the_parents,
    test_store_bytes_follow_the_modules_layout,
    test_weights_are_the_parents_bit_for_bit,
    test_work_counts_are_the_parents_exactly)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.obs import spans  # noqa: E402

FWD = "slicemoe.decode_forward"
MLA_SPAN = "slicemoe.decode_forward.mla"
LAYOUTS = {"qwen15-moe-a2.7b": ("periodic", (24, 1)),
           "jamba-v0.1-52b-8l": ("periodic", (1, 4)),
           "deepseek-v2-lite": ("deepseek_v2", (26, 1))}


def _full():
    with open(ROOT / "portbench" / "configs" / "deepseek-v2-lite.json") as f:
        return json.load(f)


def _small():
    """A DeepSeek-shaped configuration of CPU size (one leading dense
    layer, three MoE layers of 8 experts top-2)."""
    return {
        "name": "dsv2-small", "source": "test", "model": "deepseek_v2",
        "first_k_dense_replace": 1, "num_hidden_layers": 4,
        "hidden_size": 64, "num_attention_heads": 4,
        "intermediate_size": 96, "kv_lora_rank": 32,
        "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
        "rope_theta": 10000,
        "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 4,
                         "mscale": 0.707, "mscale_all_dim": 0.707,
                         "original_max_position_embeddings": 32},
        "vocab_size": 256, "d_model": 64, "norm_eps": 1e-6,
        "moe": {"n_experts": 8, "top_k": 2, "d_ff": 32,
                "n_shared_experts": 2, "d_ff_shared": 64,
                "capacity_factor": 2.0, "mlp_type": "swiglu"},
        "dtype": "float32"}


def _leaves(tree, pre=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def test_every_cell_names_its_module():
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = bench.load_cell(w["name"])
        module, layout = LAYOUTS[cell.cfg["name"]]
        assert cell.model.__name__ == f"portbench_model_{module}"
        assert tuple(cell.model.moe_layout(cell.cfg)) == layout


def test_weights_are_the_programs_tree():
    cfg = _small()
    model = loader.model_module(cfg)
    w = model.make_weights(cfg, 2 ** 31 + 1, torch.device("cpu"))
    want = dict(_leaves(TM.param_shapes(model.program_config(cfg))))
    got = dict(_leaves(w))
    assert {k: tuple(t.shape) for k, t in got.items()} == want
    for name, t in got.items():
        if name.endswith("norm"):               # every vector is zero
            assert not t.any(), name
        else:
            assert t.std() > 0, name
    again = model.make_weights(cfg, 2 ** 31 + 1, torch.device("cpu"))
    other = model.make_weights(cfg, 2 ** 31 + 2, torch.device("cpu"))
    assert all(torch.equal(again_t, got[k])
               for k, again_t in _leaves(again))
    assert not torch.equal(other["lead"]["wq"], got["lead/wq"])


def test_full_shapes_are_the_programs():
    cfg = _full()
    model = loader.model_module(cfg)
    assert dict(_leaves(model.shape_tree(cfg))) == dict(
        _leaves(TM.param_shapes(model.program_config(cfg))))


def test_store_and_counts_follow_the_moe_layers():
    cfg, engine = _full(), _engine()
    model = loader.model_module(cfg)
    per_expert = sum(serve.slice_bytes(cfg, engine))
    assert serve.store_bytes(cfg, engine) == per_expert * 26 * 64
    ids, act, crit, mask, kv = fixed_routing((26, 1), 64, 6, 32, 13)
    kv = kv * 8                                  # long-context rows
    got = C.decode_work(cfg, ids, act, crit, mask, kv[mask].tolist())
    L = model.layer_work(cfg)
    d, V, B = cfg["d_model"], cfg["vocab_size"], int(mask.sum())
    ctx = float(kv[mask].sum())
    want = C.Work(2.0 * B * (L.mm + d * V) + L.attn_flops_row * ctx,
                  L.weight_bytes + d * V * 2 + B * d * 2 + B * V * 4
                  + L.kv_bytes_row * (ctx + B))
    want += C._experts(cfg, C.expert_rows(cfg, ids, act, mask),
                       C.expert_high(cfg, ids, act, crit, mask), (8, 4))
    assert (got.flops, got.bytes) == pytest.approx((want.flops, want.bytes),
                                                   rel=1e-12)
    # Non-expert weights once: the program's parameters less the routed
    # experts and the two embeddings, in bf16, plus the final norm.
    n = cfg["hidden_size"]
    non_expert = 15_706_484_224 - 14_394_851_328 - 2 * 102_400 * n
    assert L.weight_bytes == 2 * non_expert


def _mla_trace(n_split):
    split = "(anonymous namespace)::mla_decode_split_kernel(Params)"
    merge = "(anonymous namespace)::mla_decode_merge_kernel(Params)"
    ops = [Kernel(split, 10.0 + i, 40.0, FWD, launch_us=5.0 + i)
           for i in range(n_split)]
    ops.append(Kernel(merge, 60.0, 10.0, FWD, launch_us=8.0))
    ops.append(Kernel(split, 700.0, 40.0, "slicemoe.prefill_forward",
                      launch_us=690.0))
    return Trace(window_s=1e-3, ops=ops,
                 ranges={FWD: [(0.0, 400.0)], STEP: [(0.0, 450.0)]},
                 t0_us=0.0, t1_us=1000.0)


def test_mla_roofline_reads_the_decode_kernels():
    cfg = _full()
    model = loader.model_module(cfg)
    decodes = [types.SimpleNamespace(slots={0: (1, 4000), 1: (2, 6001)})]
    read = bench.metric_reader("mla_roofline.decode")
    run = _run(cfg, model, decodes, trace=_mla_trace(2), traced=(0, 1))
    rows = 10001
    bound = max(27 * 1152 * rows / 3.35e12,
                27 * 2 * 16 * (576 + 512) * rows / 989e12)
    assert read(run) == pytest.approx(100 * bound / 90e-6, rel=1e-12)
    # A program without the kernel, and the GQA kernels' reader on MLA.
    bare = Trace(window_s=1e-3, ops=[], ranges={STEP: [(0.0, 1.0)]},
                 t0_us=0.0, t1_us=1.0)
    assert read(_run(cfg, model, decodes, trace=bare, traced=(0, 1))) \
        is None
    assert bench.metric_reader("attn_roofline.decode")(run) is None


@pytest.mark.parametrize("with_span", [True, False])
def test_mla_dispatch_reads_the_span(with_span):
    rec = spans.SPANS             # the recorder the reader reads
    rec.reset()
    try:
        for k in range(5):
            rec.open_step()
            spans.add(FWD, 0.1)
            if with_span:
                spans.add(MLA_SPAN, 0.001 * (k + 1))
            spans.close_step()
        cfg = _full()
        run = _run(cfg, loader.model_module(cfg))
        run.step_end = [0.0] * 5
        run.d_open, run.d_close = 2, 5
        got = bench.metric_reader("mla_dispatch_ms.decode")(run)
    finally:
        rec.reset()
    assert got == (pytest.approx(4.0) if with_span else None)


def test_reference_control_and_flips():
    cfg = _small()
    model = loader.model_module(cfg)
    w = model.make_weights(cfg, 3, torch.device("cpu"))
    req = fixed_request(cfg, tuple(model.moe_layout(cfg)))
    flips = np.zeros(len(req.fed), np.int64)
    logits = model.served_logits(cfg, w, req, theta=0.5, flips=flips)
    low = model.served_logits(cfg, w, req, theta=0.5, fp8=True)
    assert logits.shape == (1 + len(req.fed), cfg["vocab_size"])
    assert torch.isfinite(logits).all() and torch.isfinite(low).all()
    assert 0 < float((logits - low).abs().max()) < 1.0
    # Random routing records: most MoE layers route otherwise.
    assert flips.min() >= 0 and flips.max() <= math.prod(
        model.moe_layout(cfg)) and flips.sum() > 0
