"""The port's search slice against the JAX package: the MAC estimator,
``counts_for_subnets``, the proposal generators and the evolver (seeded, the
JAX ``backend="python"`` path), the eval steps and batched candidate scoring.

Integer results (MACs, keep counts, network_defs) must be equal. Scoring runs
a small distill supernet whose every masked LN has ``C % 128 == 0``, on the
port's ``"stats"`` route against the JAX package's Pallas statistics route.
Logits agree to about 1e-6 there, so a correct count may differ only on an
example whose top-k margin is under ``MARGIN``: each comparison allows one
such example per count and counts them from the port's logits. The head
weights are scaled up so that such near-ties are rare, as in a trained net.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_search_tpu.arch import ComputationEstimator as JaxEstimator
from vit_search_tpu.arch import presets as jax_presets
from vit_search_tpu.models import VisionTransformerSR as JaxViT
from vit_search_tpu.models.supernet import SupernetSchedules as JaxSchedules
from vit_search_tpu.search import PopulationEvolver as JaxEvolver
from vit_search_tpu.search import generators as jax_generators
from vit_search_tpu.search.batched_eval import BatchedSupernetEvaluator as JaxEvaluator
from vit_search_tpu.search.batched_eval import make_tiled_correct_step as jax_tiled_step
from vit_search_tpu.train.engine import make_eval_step as jax_make_eval_step
from vit_search_tpu.train.engine import \
    make_per_example_correct_step as jax_make_per_example_correct_step
from vit_search_torch.arch import ComputationEstimator, presets, spaces
from vit_search_torch.arch import network_def as nd
from vit_search_torch.convert import load_jax
from vit_search_torch.models import SupernetSchedules, VisionTransformerSR, build_arch_masks
from vit_search_torch.search import (BatchedSupernetEvaluator, PopulationEvolver, generators,
                                     make_tiled_correct_step)
from vit_search_torch.train import make_eval_step, make_per_example_correct_step

from test_search import _synthetic_accuracy
from test_torch_stats import jax_stats_route  # noqa: F401 (a fixture)

LARGEST = presets.SUPERNET_SR_TINY
SPACE = spaces.get_space("sr_tiny")
EST = ComputationEstimator(distill=True, input_resolution=224, patch_size=14)
JAX_EST = JaxEstimator(distill=True, input_resolution=224, patch_size=14)
CONSTRAINT = EST(LARGEST) * 0.37
TINY_BUDGET = 1.7944e9          # scripts/vit-sr-nas/evolutionary_search/tiny.sh:19

# a distill supernet, linear stem, two stages of widths 128/256 at 28px, patch 7
SUPER = ((0, 128),
         (1, (128, 2, 32), (128, 256), 1),
         (1, (128, 2, 32), (128, 256), 1),
         (3, 128, 256),
         (1, (256, 4, 32), (256, 512), 1),
         (2, 256, 10))
SUPER_SPACE = [np.array([128, 96]),
               {"attn": np.array([64, 32]), "mlp": np.array([256, 128]), "layer": None},
               {"attn": np.array([64, 32]), "mlp": np.array([256, 128]),
                "layer": np.array([128, 0])},
               np.array([256, 192]),
               {"attn": np.array([128, 64]), "mlp": np.array([512, 256]), "layer": None},
               None]
CANDIDATES = [SUPER,
              ((0, 96), (1, (96, 1, 32), (96, 128), 1), (1, (96, 2, 32), (96, 256), 0),
               (3, 96, 192), (1, (192, 2, 32), (192, 512), 1), (2, 192, 10)),
              ((0, 128), (1, (128, 2, 32), (128, 128), 1), (1, (128, 1, 32), (128, 128), 1),
               (3, 128, 256), (1, (256, 4, 32), (256, 256), 1), (2, 256, 10))]
IMG, PATCH, B = 28, 7, 4
MARGIN = 1e-4


def _normalized(images: np.ndarray) -> torch.Tensor:
    x = torch.tensor(images).float() / 255.0
    return (x - torch.tensor((0.485, 0.456, 0.406))) / torch.tensor((0.229, 0.224, 0.225))


# --- MAC estimator, keep counts, generators, evolver -------------------------------

@pytest.mark.parametrize("return_mac", [True, False], ids=["macs", "flops"])
@pytest.mark.parametrize("distill", [False, True], ids=["plain", "distill"])
@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_estimator_matches_jax_for_every_preset(name, distill, return_mac):
    got = ComputationEstimator(distill, 224, 14, return_mac=return_mac)(presets.PRESETS[name])
    want = JaxEstimator(distill, 224, 14, return_mac=return_mac)(jax_presets.PRESETS[name])
    assert got == want and isinstance(got, int)


def test_counts_for_subnets_match_jax():
    net, space = presets.SUPERNET_SR_TINY_MH, spaces.get_space("sr_tiny_mh")
    est = ComputationEstimator(distill=False, input_resolution=224, patch_size=14)
    rng = np.random.default_rng(0)
    defs = [generators.gen_random_network_def(net, space, TINY_BUDGET, est, rng=rng)
            for _ in range(6)] + [net]
    assert any(not b[3] for d in defs for b in d if nd.block_type(b) == nd.TRANSFORMER)
    got = SupernetSchedules(net, space, 1, 0).counts_for_subnets(defs)
    want = JaxSchedules(net, space, 1, 0).counts_for_subnets(defs)
    np.testing.assert_array_equal(got["embed"], want["embed"])
    assert sorted(got["slots"]) == sorted(want["slots"])
    for slot, site in want["slots"].items():
        assert sorted(got["slots"][slot]) == sorted(site)
        for key, v in site.items():
            np.testing.assert_array_equal(got["slots"][slot][key], v, err_msg=f"{slot} {key}")

    bad = nd.to_mutable(net)
    bad[1][3] = 0                 # slot 1 is not removable in sr_tiny_mh
    for sched in (SupernetSchedules(net, space, 1, 0), JaxSchedules(net, space, 1, 0)):
        with pytest.raises(ValueError, match="non-removable"):
            sched.counts_for_subnets([nd.to_immutable(bad)])


def _run_generator(mod, op, seed):
    rng = np.random.default_rng(seed)
    parent = mod.gen_random_network_def(LARGEST, SPACE, CONSTRAINT, EST, rng=rng)
    if op == "gen_random":
        out = parent
    elif op == "mutate":
        out = mod.mutate_network_def(parent, SPACE, 0.3, CONSTRAINT, EST, rng=rng)
    elif op == "crossover":
        other = mod.gen_random_network_def(LARGEST, SPACE, CONSTRAINT, EST, rng=rng)
        out = mod.crossover_network_def(parent, other, SPACE, CONSTRAINT, EST, rng=rng)
    elif op == "prune_random_one":
        out = mod.prune_random_one(nd.to_mutable(LARGEST), SPACE, rng=rng)
    else:
        out = mod.reduce_constraint(LARGEST, SPACE, CONSTRAINT, EST, rng=rng)
    return nd.to_immutable(out), int(rng.integers(1 << 30))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", ["gen_random", "mutate", "crossover", "prune_random_one",
                                "reduce_constraint"])
def test_generators_match_jax(op, seed):
    """Same network_def and the same number of draws taken from the rng."""
    assert generators.RESOURCE_LOWER_BOUND == jax_generators.RESOURCE_LOWER_BOUND == 0.975
    assert _run_generator(generators, op, seed) == _run_generator(jax_generators, op, seed)


def test_evolver_search_loop_matches_jax():
    """The full loop with the synthetic predictor of test_search.py: every
    generation and the sorted history equal the JAX python backend's."""
    predictor = _synthetic_accuracy(LARGEST)
    port = PopulationEvolver(LARGEST, SPACE, CONSTRAINT, EST, seed=0, backend="python")
    ref = JaxEvolver(LARGEST, SPACE, CONSTRAINT, JAX_EST, seed=0, backend="python")
    for it in range(4):
        for ev in (port, ref):
            if it == 0:
                ev.random_sample(num_samples=24)
            else:
                ev.evolve_sample(parent_size=10, mutate_prob=0.3, mutate_size=8)
        assert [i.network_def for i in port.popu] == [i.network_def for i in ref.popu]
        for ev in (port, ref):
            for ind in ev.popu:
                ind.score = predictor(ind.network_def)
            ev.update_history()
            ev.sort_history()
        assert [i.network_def for i in port.history_popu] == \
            [i.network_def for i in ref.history_popu]
    assert port.best().score == ref.best().score
    lo = generators.RESOURCE_LOWER_BOUND * CONSTRAINT
    assert all(lo <= EST(i.network_def) <= CONSTRAINT for i in port.history_popu)


def test_evolver_refuses_out_of_order_calls_like_jax():
    """evolve_sample before any history, with an unscored generation pending,
    and with more parents than the history holds: the same errors as JAX."""
    port = PopulationEvolver(LARGEST, SPACE, CONSTRAINT, EST, seed=3, backend="python")
    ref = JaxEvolver(LARGEST, SPACE, CONSTRAINT, JAX_EST, seed=3, backend="python")
    for ev in (port, ref):
        with pytest.raises(RuntimeError, match="history is empty"):
            ev.evolve_sample(parent_size=2, mutate_prob=0.3, mutate_size=2)
        ev.random_sample(3)
        with pytest.raises(RuntimeError, match="unscored population pending"):
            ev.evolve_sample(parent_size=2, mutate_prob=0.3, mutate_size=2)
        ev.update_history()
        with pytest.raises(ValueError, match="parent_size"):
            ev.evolve_sample(parent_size=4, mutate_prob=0.3, mutate_size=2)
    assert [i.network_def for i in port.history_popu] == \
        [i.network_def for i in ref.history_popu]


# --- eval steps and batched scoring ------------------------------------------------

@pytest.fixture(scope="module")
def distill_supernet():
    """JAX params (head weights scaled x50) and data: two uint8 batches of 4,
    the second with two padding rows."""
    jmodel = JaxViT(network_def=SUPER, img_size=IMG, patch_size=PATCH, num_classes=10,
                    distill_token=True)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, IMG, IMG, 3)))["params"])
    for head in ("cls_head", "dst_head"):
        params[head]["kernel"] = params[head]["kernel"] * 50.0
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, 10, B).astype(np.int32), valid)
               for valid in (np.ones(B, np.float32), np.array([1, 1, 0, 0], np.float32))]
    model = VisionTransformerSR(SUPER, img_size=IMG, patch_size=PATCH, num_classes=10,
                                distill_token=True, ln_route="stats", device="cpu")
    load_jax(model, params, {})
    return jmodel, params, model, batches


def _top_k_near_ties(logits: torch.Tensor, k: int) -> int:
    """Examples whose k-th and (k+1)-th logits are within MARGIN."""
    top = logits.float().topk(k + 1, dim=-1).values
    return int((top[:, k - 1] - top[:, k] < MARGIN).sum())


def test_eval_steps_match_jax(jax_stats_route, distill_supernet):
    jmodel, params, model, batches = distill_supernet
    images, labels, _ = batches[0]
    counts = JaxSchedules(SUPER, SUPER_SPACE, example_per_arch=2,
                          num_warmup_epochs=0).sample(np.random.default_rng(1), B)
    jcounts = jax.tree.map(jnp.asarray, counts)
    want = jax_make_eval_step(jmodel)(params, None, jnp.asarray(images),
                                      jnp.asarray(labels), jcounts)
    assert jax_stats_route[0] > 0
    got = make_eval_step(model, device="cpu")(torch.tensor(images), torch.tensor(labels),
                                              counts)
    assert sorted(got) == sorted(want) == sorted(
        ["count", "loss_sum", "top1", "top5", "dst_top1", "dst_top5", "jnt_top1", "jnt_top5"])
    np.testing.assert_allclose(float(got["loss_sum"]), float(want["loss_sum"]), rtol=1e-5)
    assert float(got["count"]) == float(want["count"]) == B

    with torch.no_grad():
        cls, dst = model.eval()(_normalized(images), build_arch_masks(counts, SUPER, B))
    joint = cls.softmax(-1) + dst.softmax(-1)
    for prefix, pred in (("", cls), ("dst_", dst), ("jnt_", joint)):
        for k in (1, 5):
            key = f"{prefix}top{k}"
            allowed = _top_k_near_ties(pred, k)
            assert abs(float(got[key]) - float(want[key])) <= allowed, key

    per_example = make_per_example_correct_step(model, device="cpu")(
        torch.tensor(images), torch.tensor(labels), counts)
    ref = np.asarray(jax_make_per_example_correct_step(jmodel)(
        params, None, jnp.asarray(images), jnp.asarray(labels), jcounts))
    assert per_example.shape == (B,)
    assert int((per_example.numpy() != ref).sum()) <= _top_k_near_ties(cls, 1)


def _chunk_counts(defs, device="cpu"):
    counts = SupernetSchedules(SUPER, SUPER_SPACE, 1, 0).counts_for_subnets(defs)
    return counts, jax.tree.map(jnp.asarray, JaxSchedules(SUPER, SUPER_SPACE, 1,
                                                          0).counts_for_subnets(defs))


def _tiled_logits(model, images, defs):
    """The port's tiled forward, candidate-major, for margin counting."""
    counts, _ = _chunk_counts(defs)
    a = len(defs)
    tiled = {"embed": np.repeat(counts["embed"], B),
             "slots": {s: {k: np.repeat(v, B) for k, v in site.items()}
                       for s, site in counts["slots"].items()}}
    with torch.no_grad():
        return model.eval()(_normalized(images).repeat(a, 1, 1, 1),
                            build_arch_masks(tiled, SUPER, a * B))


@pytest.mark.parametrize("head", ["cls", "dst", "joint"])
def test_tiled_correct_step_matches_jax(jax_stats_route, distill_supernet, head):
    jmodel, params, model, batches = distill_supernet
    images, labels, valid = batches[1]
    counts, jcounts = _chunk_counts(CANDIDATES)
    got, got_total = make_tiled_correct_step(model, head, device="cpu")(
        torch.tensor(images), torch.tensor(labels), torch.tensor(valid), counts)
    want, want_total = jax_tiled_step(jmodel, head)(
        params, None, jnp.asarray(images), jnp.asarray(labels),
        jnp.asarray(valid), jcounts)
    assert jax_stats_route[0] > 0
    assert float(got_total) == float(want_total) == 2.0
    cls, dst = _tiled_logits(model, images, CANDIDATES)
    pred = {"cls": cls, "dst": dst, "joint": cls.softmax(-1) + dst.softmax(-1)}[head]
    ties = (pred.float().topk(2, -1).values.diff(dim=-1).abs().squeeze(-1) < MARGIN)
    ties = (ties.view(len(CANDIDATES), B).float() * torch.tensor(valid)).sum(1).numpy()
    assert (np.abs(got.numpy() - np.asarray(want)) <= ties).all(), (got, want)


def test_evaluator_scores_match_jax(jax_stats_route, distill_supernet):
    """Three candidates at arch_batch 2 (a short last chunk, which the JAX
    evaluator pads and the port scores at its own size), validity weighting,
    and each score head, against the JAX evaluator."""
    jmodel, params, model, batches = distill_supernet
    port_sched = SupernetSchedules(SUPER, SUPER_SPACE, 1, 0)
    chunk_sizes = []
    chunk_forward = model.forward

    def counting_forward(images, masks):
        chunk_sizes.append(images.shape[0] // B)
        return chunk_forward(images, masks)

    model.forward = counting_forward
    try:
        BatchedSupernetEvaluator(model, port_sched, batches[:1], arch_batch=2,
                                 device="cpu").score(CANDIDATES)
    finally:
        del model.forward
    assert chunk_sizes == [2, 1]
    jax_sched = JaxSchedules(SUPER, SUPER_SPACE, 1, 0)
    total = sum(float(b[2].sum()) for b in batches)
    logits = [_tiled_logits(model, b[0], CANDIDATES) for b in batches]
    for head in ("auto", "cls", "dst", "joint"):
        port = BatchedSupernetEvaluator(model, port_sched, batches, arch_batch=2,
                                        score_head=head, device="cpu")
        ref = JaxEvaluator(jmodel, params, None, jax_sched, batches,
                           arch_batch=2, score_head=head)
        assert port.score_head == ref.score_head == ("dst" if head == "auto" else head)
        got, want = port.score(CANDIDATES), ref.score(CANDIDATES)
        assert len(got) == len(want) == 3 and jax_stats_route[0] > 0
        ties = np.zeros(3)
        for (cls, dst), b in zip(logits, batches):
            pred = {"cls": cls, "dst": dst,
                    "joint": cls.softmax(-1) + dst.softmax(-1)}[port.score_head]
            top = pred.float().topk(2, -1).values
            near = ((top[:, 0] - top[:, 1]) < MARGIN).view(3, B).float() * torch.tensor(b[2])
            ties += near.sum(1).numpy()
        np.testing.assert_array_less(np.abs(np.array(got) - np.array(want)),
                                     100.0 * ties / total + 1e-9)


def test_tiled_step_normalizes_uint8_before_tiling():
    """Mirror of test_search.py::test_batched_eval_normalizes_uint8_like_engine:
    a probe whose prediction is the sign of the per-example pixel mean tells
    normalized from raw pixels (constant 100 is positive raw, negative after
    the ImageNet normalization in every channel)."""
    probe_def = ((0, 16), (1, (16, 4, 4), (16, 32), 1), (2, 16, 2))
    probe_space = [np.array([16, 8]),
                   {"attn": np.array([16, 8]), "mlp": np.array([32, 16]), "layer": None},
                   None]

    class Probe(torch.nn.Module):
        network_def = probe_def
        distill_token = False

        def __init__(self):
            super().__init__()
            self.unused = torch.nn.Parameter(torch.zeros(1))

        def forward(self, images, masks):
            per_ex = images.float().mean(dim=(1, 2, 3))
            return torch.stack([per_ex, torch.zeros_like(per_ex)], dim=-1)  # 1 iff mean < 0

    counts = SupernetSchedules(probe_def, probe_space, 1, 0).counts_for_subnets([probe_def])
    step = make_tiled_correct_step(Probe(), device="cpu")
    labels, valid = torch.ones(6, dtype=torch.int64), torch.ones(6)
    correct, total = step(torch.full((6, 28, 28, 3), 100, dtype=torch.uint8), labels, valid,
                          counts)
    assert float(total) == 6.0 and float(correct[0]) == 6.0
    correct, _ = step(torch.full((6, 28, 28, 3), -1.0), labels, valid, counts)
    assert float(correct[0]) == 6.0       # float batches pass through unscaled
    correct, _ = step(torch.full((6, 28, 28, 3), 100.0), labels, valid, counts)
    assert float(correct[0]) == 0.0


def test_score_heads_need_a_distill_supernet():
    plain = VisionTransformerSR(SUPER, img_size=IMG, patch_size=PATCH, num_classes=10,
                                device="cpu")
    ev = BatchedSupernetEvaluator(plain, SupernetSchedules(SUPER, SUPER_SPACE, 1, 0), [],
                                  device="cpu")
    assert ev.score_head == "cls"
    for head in ("dst", "joint"):
        with pytest.raises(ValueError, match="distill"):
            make_tiled_correct_step(plain, head, device="cpu")
    with pytest.raises(ValueError, match="score head"):
        make_tiled_correct_step(plain, "top5", device="cpu")
