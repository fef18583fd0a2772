"""The benchmark's plain reference against the port's CPU path at tiny
widths, in float32: the towers, the image preprocessing, three
fine-tuning steps and the exact search with its tie rule. The reference
imports nothing of the port; only this test holds the two side by side."""

import numpy as np
import pytest
import torch

from perfbench.runners.common import image_buckets, load_weights, model_config, token_ids
from perfbench.reference import clip as ref_clip
from perfbench.tests.tiny import tiny_cfg  # noqa: F401 (a fixture)
from perfbench.reference import preprocess as ref_pre
from perfbench.reference import search as ref_search
from perfbench.reference import train as ref_train
from perfbench.weights import make_weights

CPU = torch.device("cpu")
SEED = 2**31 + 7


def _port_model(cfg, compute_dtype="float32"):
    from tpualign_torch.models.clip import build_clip

    cfg = dict(cfg, compute_dtype=compute_dtype)
    model = build_clip(model_config(cfg), CPU)
    load_weights(model, make_weights(cfg, SEED, CPU))
    return model.eval().requires_grad_(False)


def _tokens(n, context=77):
    return token_ids([n // 4, n // 2, n - n // 4 - n // 2], [16, 32, 77], 3, context, SEED,
                     "tokens", CPU)


@pytest.mark.parametrize("quick_gelu", [True, False])
def test_towers_match_the_port(tiny_cfg, quick_gelu):
    cfg = dict(tiny_cfg, quick_gelu=quick_gelu)
    model = _port_model(cfg)
    weights = make_weights(cfg, SEED, CPU)
    g = torch.Generator().manual_seed(1)
    pixels = torch.randn(5, 32, 32, 3, generator=g)
    tokens = _tokens(12)
    with torch.no_grad():
        got_i = model.encode_image(pixels, normalize=True)
        got_t = model.encode_text(tokens, normalize=True)
        want_i = ref_clip.image_features(weights, cfg, pixels)
        want_t = ref_clip.text_features(weights, cfg, tokens)
    torch.testing.assert_close(got_i, want_i, rtol=1e-5, atol=2e-6)
    torch.testing.assert_close(got_t, want_t, rtol=1e-5, atol=2e-6)


def test_text_buckets_leave_the_embedding_unchanged(tiny_cfg):
    """The reference at the bucket the engine cuts a row to is the
    reference at the full context (the causal mask)."""
    weights = make_weights(tiny_cfg, SEED, CPU)
    tokens = _tokens(8)
    short = tokens[:, :int(tokens.argmax(dim=1).max()) + 1]
    torch.testing.assert_close(ref_clip.text_features(weights, tiny_cfg, short),
                               ref_clip.text_features(weights, tiny_cfg, tokens),
                               rtol=1e-5, atol=2e-6)


def test_preprocess_matches_the_port():
    from tpualign_torch.ops.preprocess import preprocess_device

    u8, hw = image_buckets(6, 96, [20, 96], SEED, "images", CPU)
    hw[0] = torch.tensor([96, 40])   # tall
    hw[1] = torch.tensor([33, 96])   # wide, a downscale on one side
    got = preprocess_device(u8, hw, 64)
    want = ref_pre.preprocess(u8, hw.tolist(), 64)
    std = torch.tensor(ref_pre.CLIP_STD)
    steps = ((got - want) * std * 255.0).abs()
    # PIL's fixed-point taps against float64 ones: at most one uint8 step, rarely
    assert float(steps.max()) <= 1.0 + 1e-3
    assert float((steps > 0.5).float().mean()) < 0.01


def test_train_steps_match_the_port(tiny_cfg):
    from tpualign_torch.config import TrainConfig
    from tpualign_torch.train.step import create_train_state, model_params, train_step

    hp = {"loss_type": "clip", "learning_rate": 1e-3, "weight_decay": 0.2,
          "warmup_steps": 1, "total_steps": 10, "weak_score_temperature": 0.5,
          "label_smoothing": 0.0, "moments_dtype": "float32", "adam_b1": 0.9,
          "adam_b2": 0.98, "adam_eps": 1e-6, "max_grad_norm": 1.0, "max_logit_scale": 4.6052}
    cfg = dict(tiny_cfg, compute_dtype="float32")
    model = _port_model(cfg)
    tc = TrainConfig(batch_size=8, image_feed="device",
                     **{k: hp[k] for k in ("loss_type", "learning_rate", "weight_decay",
                                           "warmup_steps", "total_steps",
                                           "weak_score_temperature", "label_smoothing",
                                           "moments_dtype")})
    state = create_train_state(model, model_params(model), tc)
    batches, losses, first = [], [], None
    for step in range(3):
        u8, hw = image_buckets(8, 48, [20, 48], SEED, f"b{step}", CPU)
        tokens = _tokens(8)
        weak = torch.rand(8, generator=torch.Generator().manual_seed(step))
        state, metrics = train_step(state, model, (u8, hw), tokens, weak, tc)
        losses.append(float(metrics["loss"]))
        if step == 0:
            first = {k: float(v.norm()) / (1 - hp["adam_b1"])
                     for k, v in state.opt_state["mu"].items()}
        batches.append((ref_pre.preprocess(u8, hw.tolist(), 32), tokens, weak))
    start = make_weights(cfg, SEED, CPU)
    ref = ref_train.run_steps(start, cfg, batches, hp)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    for k, v in ref["first_grad"].items():
        assert abs(first[k] - v) <= 1e-3 * v + 1e-7, k
    for k, v in ref["change"].items():
        got = float((state.params[k] - start[k]).norm())
        assert abs(got - v) <= 2e-3 * v + 1e-7, k


def test_learning_rate_schedule_matches_the_port():
    from tpualign_torch.train.optim import warmup_cosine_decay

    hp = {"learning_rate": 1e-5, "warmup_steps": 200, "total_steps": 2000}
    port = warmup_cosine_decay(1e-5, 200, 2000)
    for count in (0, 1, 2, 199, 200, 201, 1500, 2000, 2500):
        assert abs(ref_train.learning_rate(hp, count) - port(count)) <= 1e-12, count


def test_search_matches_the_port_with_ties():
    from tpualign_torch.parallel.retrieval import RetrievalIndex

    g = torch.Generator().manual_seed(3)
    corpus = torch.randn(3000, 32, generator=g)
    corpus /= corpus.norm(dim=1, keepdim=True)
    corpus[2000:2010] = corpus[5]            # ties: equal rows rank by index
    queries = torch.cat([corpus[[5, 17]], torch.randn(14, 32, generator=g)])
    index = RetrievalIndex(corpus.numpy(), ["m"] * 3000, [0] * 3000, device="cpu")
    vals, idx = index.search(queries.numpy(), k=10, global_search=True)
    want_v, want_i = ref_search.exact_topk(ref_search.scores(queries, corpus.double()), 10)
    np.testing.assert_array_equal(idx, want_i.numpy())
    np.testing.assert_allclose(vals, want_v.numpy(), atol=1e-6)
    assert list(idx[0][:11 if idx.shape[1] > 10 else 10]) == [5] + list(range(2000, 2009))
