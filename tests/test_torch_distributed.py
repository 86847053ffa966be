"""Multi-process runs of the port on the CPU (``torch.distributed`` over gloo).

The contract of ``tests/test_multihost.py`` for the JAX package: a
2-process run over the same global data equals the 1-process run, and both
ranks agree bit for bit. Here for the port's train step (token mixup, drop
path, EMA and the conv stem's batch norm in train mode; then Mixup/CutMix
with erasing and dropout), ``cli.train --eval``, ``cli.evo_search`` and
``cli.launch`` (the torchrun environment and its flags, and a SIGTERM sent to
one rank only, then ``--resume auto``). Float32 runs agree within 1e-5
relative: two processes sum the gradients and the batch-norm partials in
another order than one. The two-process step is also held to the JAX step
itself, given the JAX step's draws at the global batch
(``test_torch_train_step``), and a group of one process runs every
collective.

The file is also its own worker: ``python tests/test_torch_distributed.py
MODE RANK NPROC STORE OUTDIR [ARGS...]`` runs one process of a group whose
rendezvous is the file STORE (a ``file://`` store, so that concurrent test
workers pick no TCP ports), and writes its results into OUTDIR.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the 56 px three-stage conv-stem net of tests/test_torch_model.py and its space
NET = ((4, 32),
       (1, (32, 2, 16), (32, 64), 1),
       (1, (32, 2, 16), (32, 64), 1),
       (3, 32, 64),
       (1, (64, 4, 16), (64, 128), 1),
       (3, 64, 128),
       (1, (128, 4, 32), (128, 256), 1),
       (2, 128, 10))
SPACE = [np.array([32, 24]),
         {"attn": np.array([32, 16]), "mlp": np.array([64, 48]), "layer": None},
         {"attn": np.array([32, 16]), "mlp": np.array([64, 48]), "layer": np.array([32, 0])},
         np.array([64, 48]),
         {"attn": np.array([64, 32]), "mlp": np.array([128, 96]), "layer": None},
         np.array([128, 96]),
         {"attn": np.array([128, 64]), "mlp": np.array([256, 192]), "layer": None},
         None]
CLASSES = 4
SUPER_NET = NET[:-1] + ((2, 128, CLASSES),)
SPACE_NAME = "torch_distributed_56"
GLOBAL_BATCH, STEPS = 16, 3
RTOL = 1e-5
SUPERNET = ["--model", "flexible_vit_sr_patch14_224_patch_output_supernet",
            "--network-def", repr(SUPER_NET), "--search-space", SPACE_NAME]
COMMON = ["--data-path", "", "--input-size", "56", "--num_workers", "1",
          "--no-repeated-aug", "--no-bf16", "--device", "cpu", "--seed", "0"]


# --- the worker ------------------------------------------------------------------

def _train_steps(mixup: bool):
    """``STEPS`` supernet steps (one under ``mixup``) on this process's rows
    of a seeded global batch: the per-step loss and grad norm, and the final
    parameters, batch-norm statistics and EMA."""
    from vit_search_torch import parallel
    from vit_search_torch.models import SupernetSchedules, create_model
    from vit_search_torch.train import (OptimConfig, TrainConfig, lr_schedule,
                                        make_optimizer, make_train_step)

    name = ("flexible_vit_sr_patch14_224_supernet" if mixup
            else "flexible_vit_sr_patch14_224_patch_output_supernet")
    model = create_model(name, network_def=NET, img_size=56, drop_path_rate=0.1,
                         dropout_rate=0.1 if mixup else 0.0, seed=0, device="cpu")
    ocfg = OptimConfig(base_lr=1e-3, warmup_epochs=0, epochs=1, steps_per_epoch=4,
                       global_batch_size=GLOBAL_BATCH)
    sched = SupernetSchedules(NET, SPACE, example_per_arch=2, num_warmup_epochs=0)
    if mixup:   # elem mode: each row mixes with the flipped global batch's
        tcfg = TrainConfig(num_classes=10, mixup_mode="mixup", mixup_elem_mode="elem",
                           ema_decay=0.99, erasing_prob=0.5)
    else:
        tcfg = TrainConfig(num_classes=10, mixup_mode="token", patch_len=1, ema_decay=0.99)
    step = make_train_step(model, make_optimizer(ocfg, model), tcfg,
                           schedule=lr_schedule(ocfg), counts_unpack=sched.unpack,
                           seed=0, device="cpu")
    data = np.random.default_rng(0)
    images = torch.as_tensor(data.integers(0, 256, (GLOBAL_BATCH, 56, 56, 3), dtype=np.uint8))
    labels = torch.as_tensor(data.integers(0, 10, (GLOBAL_BATCH,)))
    lo, hi = parallel.batch_slice(GLOBAL_BATCH)
    arch_rng = np.random.default_rng(1)
    out = {"loss": [], "grad_norm": [], "lr": []}
    grad_max = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    for _ in range(1 if mixup else STEPS):
        m = step(images[lo:hi], labels[lo:hi], sched.sample_packed(arch_rng, GLOBAL_BATCH))
        for k in ("loss", "grad_norm", "lr"):
            out[k].append(float(m[k]))
        for k, p in model.named_parameters():
            torch.maximum(grad_max[k], p.grad.abs(), out=grad_max[k])
    tensors = {"params": {k: p.detach() for k, p in model.named_parameters()},
               "buffers": dict(model.named_buffers()), "ema": step.state.ema_params,
               "grad_max": grad_max}
    return out, tensors


def port_step(ref, device="cpu"):
    """The port's model and train step from the weights and configs of
    ``test_torch_train_step.jax_reference_step``'s dict."""
    from vit_search_torch.models import SupernetSchedules, VisionTransformerSR
    from vit_search_torch.train import lr_schedule, make_optimizer, make_train_step

    model = VisionTransformerSR(**ref["model_kwargs"], device=device)
    model.load_state_dict(ref["state_dict"])
    sched = SupernetSchedules(ref["model_kwargs"]["network_def"], ref["space"],
                              example_per_arch=2, num_warmup_epochs=0)
    step = make_train_step(model, make_optimizer(ref["ocfg"], model), ref["tcfg"],
                           schedule=lr_schedule(ref["ocfg"]), counts_unpack=sched.unpack,
                           device=device)
    return model, step


def _jax_draws_step(outdir, rank):
    """The JAX reference step on this process's rows, with the reference's
    draws at the global shape: the metrics, the (averaged) gradients and
    the state dict after the step."""
    from vit_search_torch import parallel

    ref = torch.load(os.path.join(outdir, "ref.pt"), weights_only=False)
    model, step = port_step(ref)
    lo, hi = parallel.batch_slice(len(ref["labels"]))
    metrics = step(torch.tensor(ref["images"][lo:hi]), torch.tensor(ref["labels"][lo:hi]),
                   ref["counts"], draws=ref["draws"])
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
                "state": model.state_dict()},
               os.path.join(outdir, f"jax_draws_rank{rank}.pt"))
    return {}


def _worker(argv):
    mode, rank, nproc, store, outdir, *rest = argv
    rank, nproc = int(rank), int(nproc)
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)   # the same CPU reductions in every process
    from vit_search_torch import parallel
    from vit_search_torch.arch import spaces

    spaces.register_space(SPACE_NAME, lambda: SPACE)
    if not mode.startswith("launch") and nproc > 1:
        parallel.init_distributed(f"file://{store}", nproc, rank, device="cpu")
    if mode == "jax-draws":
        result = _jax_draws_step(outdir, rank)
    elif mode == "steps":
        result, tensors = {}, {}
        for tag, mixup in (("token", False), ("mixup", True)):
            result[tag], tensors[tag] = _train_steps(mixup)
        torch.save(tensors, os.path.join(outdir, f"tensors_rank{rank}.pt"))
    elif mode in ("cli", "evo"):
        from vit_search_torch.cli import evo_search, train

        cli = train if mode == "cli" else evo_search
        result = cli.main(cli.get_args_parser().parse_args(rest))
    else:   # launch, launch-preempt: the launcher joins the group itself
        from vit_search_torch.cli import launch, train

        results, coords, main = [], {}, train.main

        def run(args):
            coords.update(rank=parallel.process_index(), world=parallel.process_count())
            results.append(main(args))
            return results[-1]

        train.main = run
        if mode == "launch-preempt" and rank == 1:
            # SIGTERM to this rank alone, once its second step has run
            from vit_search_torch.train.engine import TrainStep

            step_call = TrainStep.__call__

            def call(self, *args, **kwargs):
                out = step_call(self, *args, **kwargs)
                if self.state.step == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            TrainStep.__call__ = call
        assert launch.main(rest) == 0
        result = {"runs": results, "coords": coords}
    parallel.shutdown()
    with open(os.path.join(outdir, f"result_rank{rank}.json"), "w") as f:
        json.dump(result, f)


# --- the tests -------------------------------------------------------------------

def _spawn(mode, nproc, outdir, args=(), env=None):
    """Run ``nproc`` workers of one group; each one's result dict."""
    os.makedirs(outdir, exist_ok=True)
    store = os.path.join(outdir, f"store_{mode}")
    base = {k: v for k, v in os.environ.items() if not k.startswith(("RANK", "WORLD_SIZE",
                                                                      "LOCAL_RANK", "MASTER_"))}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(nproc), store,
         str(outdir), *[a.replace("{store}", store) for a in args]],
        env={**base, **(env(r) if env else {})}, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(nproc)]
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {mode} failed:\n{out[-4000:]}"
    results = []
    for r in range(nproc):
        with open(os.path.join(outdir, f"result_rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _close(got, want, what):
    """Scalars (losses, grad norms): within ``RTOL`` of each value."""
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=RTOL, atol=0,
                               err_msg=what)


def _close_tensor(got, want, what, noise=None, bound=0.0):
    """Tensors: ``||got - want|| <= RTOL * ||want||``. An entry whose
    gradient is a sum that nearly cancels (a bias of a masked unit) takes
    AdamW's step from a gradient whose leading digits depend on the order of
    the sums, so entries are held to their tensor's norm, not one by one.
    The ``noise`` entries, whose gradient was never above 1e-7 in either run
    but not always 0 (the key bias: softmax ignores it), take AdamW's step ``lr * g / (|g| + 1e-8)``
    from rounding noise alone, in a direction the order of the sums decides:
    each is held to ``bound`` (2 lr per step), and the rest to the norm."""
    got, want = got.double(), want.double()
    if noise is not None and noise.any():
        worst = float((got - want)[noise].abs().max())
        assert worst <= bound, f"{what}: a noise-gradient entry moved {worst} > {bound}"
        got, want = got[~noise], want[~noise]
    err = float((got - want).norm())
    assert err <= RTOL * float(want.norm()), f"{what}: |diff| {err}, |want| {want.norm()}"


def test_the_net_is_the_model_tests_net():
    from test_torch_model import NET as MODEL_NET, SPACE as MODEL_SPACE

    assert NET == MODEL_NET
    assert repr(SPACE) == repr(MODEL_SPACE)


@pytest.fixture(scope="module")
def train_steps(tmp_path_factory):
    root = tmp_path_factory.mktemp("steps")
    runs = {}
    for nproc in (2, 1):
        out = root / f"n{nproc}"
        results = _spawn("steps", nproc, out)
        runs[nproc] = [(results[r], torch.load(out / f"tensors_rank{r}.pt", weights_only=True))
                       for r in range(nproc)]
    return runs


@pytest.mark.parametrize("tag", ["token", "mixup"])
def test_two_process_steps_agree_bit_for_bit_across_ranks(train_steps, tag):
    (r0, t0), (r1, t1) = train_steps[2]
    assert r0[tag] == r1[tag]
    for part in ("params", "buffers", "ema"):
        for k, v in t0[tag][part].items():
            assert torch.equal(v, t1[tag][part][k]), (tag, part, k)


@pytest.mark.parametrize("tag", ["token", "mixup"])
def test_two_process_steps_equal_one_process(train_steps, tag):
    """Token mixup (3 steps) and Mixup/CutMix in elem mode with erasing and
    dropout (1 step), drop path, EMA and the conv stem's train-mode batch
    norm: losses, grad norms, batch-norm statistics, parameters and EMA of
    the 2-process run within 1e-5 relative of the 1-process run's."""
    (two, t_two), = train_steps[2][:1]
    (one, t_one), = train_steps[1]
    _close(two[tag]["loss"], one[tag]["loss"], "loss")
    _close(two[tag]["grad_norm"], one[tag]["grad_norm"], "grad_norm")
    assert all(np.isfinite(two[tag]["loss"]))
    bn = [k for k in t_one[tag]["buffers"] if k.endswith(("running_mean", "running_var"))]
    assert bn, "the conv stem keeps batch-norm statistics"
    bound = 2 * sum(one[tag]["lr"])
    for part in ("params", "buffers", "ema"):
        for k, v in t_one[tag][part].items():
            noise = None
            if part != "buffers":   # exact zeros (masked units) are not noise
                g = torch.maximum(t_one[tag]["grad_max"][k], t_two[tag]["grad_max"][k])
                noise = (g > 0) & (g < 1e-7)
            _close_tensor(t_two[tag][part][k], v, f"{tag} {part} {k}", noise, bound)


def test_two_process_steps_moved_the_batch_norm(train_steps):
    """The runs did exercise the train-mode batch norm: its running
    statistics left their initial values."""
    (_, t), = train_steps[1]
    mean = [v for k, v in t["token"]["buffers"].items() if k.endswith("running_mean")]
    assert mean and all(v.abs().max() > 0 for v in mean)


@pytest.fixture(scope="module")
def jax_draws(tmp_path_factory):
    """``test_torch_train_step``'s JAX step, and the same step in two
    processes of 4 rows each, given the JAX step's draws (token-mix
    permutations and box, drop-path keeps) at the global batch of 8."""
    from test_torch_train_step import jax_reference_step

    with pytest.MonkeyPatch.context() as mp:
        ref = jax_reference_step(mp)
    out = tmp_path_factory.mktemp("jax_draws")
    torch.save(ref, out / "ref.pt")
    _spawn("jax-draws", 2, out)
    return ref, [torch.load(out / f"jax_draws_rank{r}.pt", weights_only=False)
                 for r in range(2)]


@pytest.mark.parametrize("rank", [0, 1])
def test_two_process_step_with_the_jax_draws_matches_jax(jax_draws, rank):
    """The global batch's step, held to the JAX step as the 1-process port
    is (test_torch_train_step's tolerances); both ranks bit for bit equal."""
    from test_torch_train_step import assert_step_matches_jax

    ref, ranks = jax_draws
    got = ranks[rank]
    assert_step_matches_jax(ref, got["metrics"], got["grads"], got["state"])
    other = ranks[1 - rank]
    assert got["metrics"] == other["metrics"]
    for part in ("grads", "state"):
        for k, v in got[part].items():
            assert np.array_equal(np.asarray(v), np.asarray(other[part][k])), (part, k)


def test_a_one_process_group_runs_every_collective(tmp_path, monkeypatch):
    """``cli.launch`` with ``WORLD_SIZE=1`` joins a group of one, and every
    collective of ``parallel`` runs in it (a sum over one process) and gives
    its input back; the conv stem's train-mode batch norm gives the bits it
    gives without a group."""
    import torch.distributed as dist

    from vit_search_torch import parallel
    from vit_search_torch.models.patch_embed import BatchNorm

    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    alone = BatchNorm(3)
    y_alone = alone(x)
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        def spy(*args, _fn=getattr(dist, name), _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(dist, name, spy)
    parallel.init_distributed(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        assert parallel.process_count() == 1 and "rank 0 of 1 over gloo" in parallel.describe()
        calls.clear()   # the probe
        totals = np.array([3, 5], dtype=np.int64)
        got = parallel.all_reduce_sum(totals)
        assert got.dtype == totals.dtype and np.array_equal(got, totals)
        assert torch.equal(parallel.all_reduce_sum(x), x)
        assert parallel.any_process(True) and not parallel.any_process(False)
        parallel.barrier()
        assert torch.equal(parallel.all_gather(x), x)
        grads = [x.clone(), x[0].clone()]
        parallel.all_reduce_mean_(grads)
        assert torch.equal(grads[0], x) and torch.equal(grads[1], x[0])
        leaf = x.clone().requires_grad_()
        parallel.sum_over_processes(leaf).sum().backward()
        assert torch.equal(leaf.grad, torch.ones_like(x))
        grouped = BatchNorm(3)
        parallel.replicate(grouped)
        assert torch.equal(grouped(x), y_alone)
        assert torch.equal(grouped.running_mean, alone.running_mean)
        assert torch.equal(grouped.running_var, alone.running_var)
        assert set(calls) == {"all_reduce", "all_gather", "broadcast", "barrier"}
    finally:
        parallel.shutdown()


def test_cli_eval_two_process_equals_one_process(tmp_path):
    """``cli.train --eval``: each rank scores its shard of the val split and
    the totals are summed over processes; acc1/acc5/loss equal."""
    args = COMMON + ["--eval", "--data-set", "SYNTHETIC:4:64:56", "--batch-size", "8",
                     "--val-bs", "8", "--model", "flexible_vit_sr_patch14_224",
                     "--network-def", repr(SUPER_NET)]
    two = _spawn("cli", 2, tmp_path / "two", args)
    one = _spawn("cli", 1, tmp_path / "one", args)
    assert two[0] == two[1]
    for k in ("acc1", "acc5", "loss"):
        _close(two[0]["eval"][k], one[0]["eval"][k], k)


def test_launch_reads_the_torchrun_environment_and_flags_override_it(monkeypatch):
    import argparse

    from vit_search_torch.cli import launch

    for key, value in (("RANK", "3"), ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1"),
                       ("MASTER_ADDR", "10.0.0.2"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(key, value)
    none = argparse.Namespace(coordinator_address=None, num_processes=None, process_id=None)
    assert launch.process_coords(none) == {"coordinator_address": "10.0.0.2:29500",
                                           "num_processes": 8, "process_id": 3,
                                           "local_rank": 1}
    flags = argparse.Namespace(coordinator_address="file:///tmp/x", num_processes=2,
                               process_id=0)
    assert launch.process_coords(flags) == {"coordinator_address": "file:///tmp/x",
                                            "num_processes": 2, "process_id": 0,
                                            "local_rank": 1}
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key)
    assert launch.torchrun_process_env() == {}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """``cli.launch`` under a torchrun environment for two ranks whose
    coordinator flag overrides the environment's (a port nobody listens on):
    a SIGTERM to rank 1 alone after its second step, then the same command
    again, which resumes with ``--resume auto`` and completes."""
    out = str(tmp_path_factory.mktemp("launch"))
    args = ["--coordinator-address", "file://{store}"] + COMMON + SUPERNET + [
        "--data-set", "SYNTHETIC:4:64:56", "--batch-size", "4", "--val-bs", "8",
        "--epochs", "2", "--max-steps-per-epoch", "3", "--print-freq", "2",
        "--example-per-arch", "2", "--num-warmup-epochs", "1", "--use-patch-mixup",
        "--mixup-patch-len", "1", "--warmup-epochs", "0", "--lr", "2e-3",
        "--model-ema-decay", "0.9", "--drop-path", "0.1", "--output_dir",
        os.path.join(out, "run")]

    def env(rank):
        return {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}

    from vit_search_torch.train import restore_raw

    first = _spawn("launch-preempt", 2, os.path.join(out, "first"), args, env)
    meta = restore_raw(os.path.join(out, "run", "checkpoints", "checkpoint"))["metadata"]
    second = _spawn("launch", 2, os.path.join(out, "second"), args, env)
    return out, (first, meta), second


def test_one_rank_sigterm_stops_both_ranks_at_one_step(launched):
    _, (first, meta), _ = launched
    assert [r["coords"] for r in first] == [{"rank": 0, "world": 2}, {"rank": 1, "world": 2}]
    # no checkpoint yet: the launcher's --resume auto fails and it starts afresh
    ends = [r["runs"][-1] for r in first]
    assert ends[0] == ends[1] == {"preempted": True, "epoch": 0, "step": 1}
    assert (meta["preempted_step"], meta["steps_per_epoch"], meta["epoch"]) == (1, 3, -1)


def test_resume_auto_completes_on_both_ranks(launched):
    out, _, second = launched
    ends = [r["runs"] for r in second]
    assert len(ends[0]) == len(ends[1]) == 1     # the checkpoint was found
    for end in ends:
        end[0].pop("train_imgs_per_sec")   # each rank's own clock
    assert ends[0] == ends[1] and ends[0][0]["epoch"] == 1
    with open(os.path.join(out, "run", "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0, 1]   # rank 0 alone writes
    assert all(np.isfinite(line["train_loss"]) for line in lines)


def test_cli_evo_search_two_process_equals_one_process(launched, tmp_path):
    """``cli.evo_search`` on the launched run's supernet, over a sub-val of
    35 images (rank 1's shard ends in a cross-shard pad): the same best
    network_def and per-iteration best scores on both ranks and in the
    1-process run, on the native generators."""
    from vit_search_torch.arch import ComputationEstimator

    out, _, _ = launched
    est = ComputationEstimator(distill=False, input_resolution=56, patch_size=14)
    args = [
        "--data-path", "", "--input-size", "56", "--num_workers", "1", "--no-bf16",
        "--device", "cpu", "--seed", "0", "--data-set", "SYNTHETIC:4:35:56", "--val-bs", "8",
        "--model", "flexible_vit_sr_patch14_224_patch_output",
        "--model-path", os.path.join(out, "run", "checkpoints", "checkpoint"),
        "--network-def", repr(SUPER_NET), "--search-space", SPACE_NAME,
        "--constraint-value", str(est(SUPER_NET) * 0.998), "--search-iter", "2",
        "--init-popu-size", "6", "--parent-size", "4", "--mutate-size", "3",
        "--arch-batch", "4"]
    two = _spawn("evo", 2, tmp_path / "two", args + ["--output_dir", str(tmp_path / "out2")])
    one = _spawn("evo", 1, tmp_path / "one", args)
    assert two[0] == two[1]
    assert two[0]["backend"] == one[0]["backend"] == "native"
    assert two[0]["best_network_def"] == one[0]["best_network_def"]
    assert two[0]["best_per_iter"] == one[0]["best_per_iter"]
    assert len(set(two[0]["best_per_iter"])) >= 1 and 0 <= two[0]["best_score"] <= 100
    # rank 0 alone writes the search's files
    assert sorted(os.listdir(tmp_path / "out2")) == [
        "debug.log", "event.log", "history.csv", "iter@0_popu.pickle", "iter@0_popu.txt",
        "iter@1_popu.pickle", "iter@1_popu.txt", "summary.txt", "verbose.log"]


if __name__ == "__main__":
    _worker(sys.argv[1:])
