"""DeepSeek-V2's multi-head latent attention, its leading dense layer and
YaRN in the port, held to the benchmark's plain reference on the CPU.

On a small DeepSeek-shaped configuration (one leading dense layer, three
MoE layers of 8 experts top-2 with 2 shared experts, MLA with a latent of
32, rope dims of 16 under YaRN over 32 positions, shorter than the
sequences here), seeded random weights in f32:

* the port's float model, ``prefill`` and then ``decode_step`` through the
  latent cache (no engine), at a scalar position and at per-sequence
  positions of two requests installed into one batch cache, against the
  model module's plain forward (``portbench/models/deepseek_v2.py``,
  ``plain_logits``: its own MLA, dense and MoE functions, plain top-k
  routing, float experts): logits within 1e-4, every expert id equal (the
  capacity is set past any load, as the plain forward has none);
* the absorbed decode's plain route (``kernels/mla_decode/ref.py``) against
  the non-absorbed form, within 1e-4;
* YaRN's frequencies and the softmax scale, the port's and the
  reference's, against the formulas at the published settings;
* ``param_count`` of the full configuration (shapes only);
* a served run through ``PersistentEngine`` and the scheduler with
  continuous batching and staggered admissions, counted in scheduler
  steps: each served token's logit within the benchmark cell's limits of
  the reference's ``served_logits``, and the exact checks at 0.

The benchmark's package is found from the repository's root, as
``portbench/run.py`` finds it.
"""

import dataclasses
import json
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from portbench.lib import bench, loader, serve  # noqa: E402
from portbench.lib.traffic import Mix  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.engine import PersistentEngine  # noqa: E402
from repro_torch.kernels.mla_decode import ref as MD_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as MDL  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-4      # f32 on both sides; only the order of the sums differs

SMALL = {
    "name": "dsv2-small", "source": "test", "model": "deepseek_v2",
    "first_k_dense_replace": 1, "num_hidden_layers": 4, "hidden_size": 64,
    "num_attention_heads": 4, "intermediate_size": 96, "kv_lora_rank": 32,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
    "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 4,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 32, "type": "yarn"},
    "vocab_size": 256, "d_model": 64, "norm_eps": 1e-6,
    "moe": {"n_experts": 8, "top_k": 2, "d_ff": 32, "n_shared_experts": 2,
            "d_ff_shared": 64, "capacity_factor": 100.0,
            "mlp_type": "swiglu"},
    "dtype": "float32"}


def _full_cfg():
    with open(ROOT / "portbench" / "configs" / "deepseek-v2-lite.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small():
    model = loader.model_module(SMALL)
    return model, model.make_weights(SMALL, 2 ** 31 + 5, CPU), \
        model.program_config(SMALL)


def _seq(n, seed):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], n)


# ------------------------------------------------------- float model
def test_prefill_then_decode_matches_the_plain_forward(small):
    model, w, mcfg = small
    seq = _seq(45, 1)
    S = 37                                   # past YaRN's 32 positions
    want, want_ids = model.plain_logits(SMALL, w, seq)
    logits, cache, aux = MDL.prefill(w, mcfg, torch.as_tensor(seq[None, :S]),
                                     48, collect_trace=True)
    assert set(cache) == {"pos", "lead", "pos0"}
    assert cache["lead"]["ckv"].shape == (1, 1, 48, 32)
    assert cache["pos0"]["kpe"].shape == (3, 1, 48, 16)
    torch.testing.assert_close(logits[0], want[S - 1], atol=TOL, rtol=0)
    assert torch.equal(aux["moe"]["ids"][:, 0], want_ids[:, :S])
    for t in range(S, len(seq)):
        logits, cache, aux = MDL.decode_step(
            w, mcfg, torch.as_tensor(seq[t:t + 1]), cache,
            collect_trace=True)
        torch.testing.assert_close(logits[0], want[t], atol=TOL, rtol=0)
        assert torch.equal(aux["moe"]["ids"][:, 0, 0], want_ids[:, t])


def test_batched_decode_at_per_sequence_positions(small):
    model, w, mcfg = small
    lens = (21, 34)
    seqs = [_seq(n + 6, 10 + i) for i, n in enumerate(lens)]
    wants = [model.plain_logits(SMALL, w, s) for s in seqs]
    batch = MDL.init_cache(mcfg, 2, 48, device=CPU)
    batch["pos"] = torch.zeros(2, dtype=torch.int64)
    for slot, (s, n) in enumerate(zip(seqs, lens)):
        _, req, _ = MDL.prefill(w, mcfg, torch.as_tensor(s[None, :n]), 48)
        PersistentEngine.install_slot(batch, req, slot)
    assert batch["pos"].tolist() == list(lens)
    for j in range(6):
        tok = torch.as_tensor([s[n + j] for s, n in zip(seqs, lens)])
        logits, batch, aux = MDL.decode_step(w, mcfg, tok, batch,
                                             collect_trace=True)
        for b, ((want, ids), n) in enumerate(zip(wants, lens)):
            torch.testing.assert_close(logits[b], want[n + j], atol=TOL,
                                       rtol=0)
            assert torch.equal(aux["moe"]["ids"][:, 0, b], ids[:, n + j])


def test_absorbed_decode_matches_the_non_absorbed_form():
    g = torch.Generator().manual_seed(3)
    B, S, H, R, dn, dr, dv = 3, 40, 4, 32, 16, 8, 24

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    ckv, kpe = rnd(B, S, R), rnd(B, S, dr)
    q, ckv_new, kpe_new = rnd(B, H, dn + dr), rnd(B, R), rnd(B, dr)
    w_b = rnd(R, H, dn + dv) * R ** -0.5
    pos = torch.tensor([0, 17, S - 1])
    freqs = L.yarn_frequencies(dr, 1e4, 4.0, 16, 32.0, 1.0)
    scale = 0.21
    # Absorbed: q_lat = W_UK q_nope, attention over the latent rows, W_UV.
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :dn], w_b[..., :dn])
    c1, k1 = ckv.clone(), kpe.clone()
    o_lat = MD_ref.mla_decode_fused_ref(q_lat, q[..., dn:], ckv_new,
                                        kpe_new, c1, k1, pos, freqs,
                                        scale=scale)
    absorbed = torch.einsum("bhr,rhv->bhv", o_lat, w_b[..., dn:])
    # Non-absorbed: each head's K-nope and V lifted from every latent row.
    c2, k2 = ckv.clone(), kpe.clone()
    rows = torch.arange(B)
    c2[rows, pos] = ckv_new
    k2[rows, pos] = MD_ref.rope_at(kpe_new[:, None], pos, freqs)[:, 0]
    q_pe = MD_ref.rope_at(q[..., dn:], pos, freqs)
    kv = torch.einsum("bsr,rhc->bshc", c2, w_b)
    k = torch.cat([kv[..., :dn], k2[:, :, None].expand(B, S, H, dr)], -1)
    s = torch.einsum("bhc,bshc->bhs", torch.cat([q[..., :dn], q_pe], -1),
                     k) * scale
    s = s.masked_fill(torch.arange(S)[None, None] > pos[:, None, None],
                      float("-inf"))
    plain = torch.einsum("bhs,bshv->bhv", torch.softmax(s, -1), kv[..., dn:])
    assert torch.equal(c1, c2) and torch.equal(k1, k2)
    torch.testing.assert_close(absorbed, plain, atol=TOL, rtol=0)


# ------------------------------------------------------- YaRN, sizes
def test_yarn_frequencies_and_scale_at_the_published_settings():
    m_pub = 0.1 * 0.707 * math.log(40) + 1.0
    i = np.arange(32, dtype=np.float64)
    e = 10000.0 ** (-2 * i / 64)
    low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                     / (2 * math.log(10000)))
    high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                     / (2 * math.log(10000)))
    assert (low, high) == (10, 23)
    r = np.clip((i - low) / (high - low), 0, 1)
    want = torch.tensor(e / 40 * r + e * (1 - r), dtype=torch.float32)
    mla = get_config("deepseek-v2-lite").mla
    freqs, cos_scale = L.mla_rope(mla, 10000.0)
    torch.testing.assert_close(freqs, want, rtol=1e-6, atol=0)
    assert cos_scale == 1.0
    assert L.mla_softmax_scale(mla) == pytest.approx(192 ** -0.5 * m_pub ** 2,
                                                     rel=1e-12)
    assert L.mla_softmax_scale(mla) == pytest.approx(0.114721, abs=1e-6)
    ref_freqs, ref_cos, ref_sigma = loader.model_module(
        _full_cfg()).yarn(_full_cfg())
    torch.testing.assert_close(ref_freqs, want, rtol=1e-6, atol=0)
    assert (ref_cos, ref_sigma) == pytest.approx(
        (1.0, L.mla_softmax_scale(mla)), rel=1e-12)


def test_full_config_counts_the_published_parameters():
    cfg = get_config("deepseek-v2-lite")
    assert cfg.param_count() == 15_706_484_224
    assert (cfg.n_periods, cfg.lead_dense_layers) == (26, 1)
    full = _full_cfg()
    model = loader.model_module(full)
    assert model.moe_layout(full) == (26, 1)
    assert model.program_config(full) == dataclasses.replace(
        cfg, source=full["source"])
    n = sum(math.prod(s) for s in _leaves(model.shape_tree(full)))
    assert n == cfg.param_count()
    work = model.layer_work(full)
    assert work.attn_flops_row == 27 * 2 * 16 * (576 + 512)
    assert work.kv_bytes_row == 27 * 1152


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


# ------------------------------------------------------- served run
def test_served_tokens_lie_within_the_cells_limits():
    cfg = dict(SMALL, moe=dict(SMALL["moe"], capacity_factor=2.0))
    model = loader.model_module(cfg)
    with open(ROOT / "portbench" / "configs" / "engine.json") as f:
        engine_cfg = json.load(f)
    with open(ROOT / "portbench" / "checks" /
              "dsv2lite-longkv-c32.json") as f:
        limits = json.load(f)
    mix = Mix.from_json({
        "loop": "closed", "clients": 3, "max_batch": 3,
        "prompt": {"kind": "lognormal", "value": 30, "sigma": 0.5,
                   "min_len": 12, "max_len": 48},
        "output": {"kind": "lognormal", "value": 8, "sigma": 0.6,
                   "min_len": 3, "max_len": 16},
        "strata": 3, "warmup_steps": 0, "trace_steps": 0})
    seed = 2 ** 31 + 77
    engine, sched, probe, loop = serve.build(cfg, engine_cfg, mix, seed,
                                             CPU, model)
    steps = 40
    for _ in range(steps):
        loop.step()
    admitted = sorted({p.step for p in probe.prefills})
    assert len(admitted) > 2 and admitted[-1] > 0    # staggered admissions
    cell = bench.Cell("dsv2-small", cfg, engine_cfg, mix, limits, 1,
                      {False: [], True: []}, model)
    run = bench.Run(cell=cell, seconds=0.0, setup_s=0.0, t_open=0.0,
                    t_close=0.0, d_open=0, d_close=steps,
                    step_end=loop.step_end, wall_step_s=sched.wall_step_s,
                    wall_prefill_s=sched.wall_prefill_s,
                    decodes=probe.decodes, prefills=probe.prefills)
    served = bench.Served(run, loop)
    bench._host_records(run)
    assert len(served.finished) >= limits["sample_requests"] // 2
    assert served.attempted_failed()[1] == 0
    checks = bench.check(run, served, seed, CPU)
    assert checks["tokens_judged"]["value"] > 20
    assert bench.passed(checks), checks
    assert checks["mean_logit_gap"]["value"] < 1e-3
