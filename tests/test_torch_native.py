"""The port's native (C++) search runtime against the JAX package's.

``vit_search_torch.native`` builds a copy of the JAX package's C++ source;
under one seed its three operators must draw the JAX package's candidates,
and its cost model must equal the port's ``arch.cost`` estimator. The JAX
side is built here into a private file under ``tmp_path`` (its module's
``_LIB_PATH`` patched, its load state reset): the JAX module builds in place
otherwise, and its own tests use that path.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import vit_search_tpu.native as jax_native
from vit_search_torch import native
from vit_search_torch.arch import ComputationEstimator, presets, spaces
from vit_search_torch.arch import network_def as nd
from vit_search_torch.search import PopulationEvolver
from vit_search_tpu.arch import ComputationEstimator as JaxEstimator
from vit_search_tpu.search import PopulationEvolver as JaxEvolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGEST = presets.SUPERNET_SR_TINY_MH
SPACE = spaces.get_space("sr_tiny_mh")
TINY_BUDGET = 1.7944e9   # scripts/vit-sr-nas/evolutionary_search/tiny.sh
EST = ComputationEstimator(distill=False, input_resolution=224, patch_size=14)
JAX_EST = JaxEstimator(distill=False, input_resolution=224, patch_size=14)
SEEDS = range(4)


@pytest.fixture(scope="module")
def jax_ops(tmp_path_factory):
    """The JAX package's ``native`` module on a private build."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH",
                   str(tmp_path_factory.mktemp("jax_native") / "libvitsearch_native.so"))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_error", None)
        assert jax_native.available(), jax_native._load_error
        yield jax_native.NativeSearchOps(LARGEST, SPACE, TINY_BUDGET, distill=False)


@pytest.fixture(scope="module")
def ops():
    assert native.available(), native.load_error()
    return native.NativeSearchOps(LARGEST, SPACE, TINY_BUDGET, distill=False)


def _removed(net, every=2):
    """``net`` with every ``every``-th transformer block marked removed."""
    blocks = nd.to_mutable(net)
    seen = 0
    for block in blocks:
        if nd.block_type(block) == nd.TRANSFORMER:
            seen += 1
            if seen % every == 0:
                block[3] = 0
    return nd.to_immutable(blocks)


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_encode_decode_round_trip(name):
    net = presets.PRESETS[name]
    assert native.decode_net(native.encode_net(net), net) == net
    assert np.array_equal(native.encode_net(net), jax_native.encode_net(net))


def test_the_source_is_the_jax_packages_but_for_comments():
    def code(path):
        with open(path) as f:
            return [line for line in f if not line.lstrip().startswith("//")]

    assert code(native._SRC) == code(jax_native._SRC)


NETS = [(name, removed) for name in sorted(presets.PRESETS) for removed in (False, True)]


@pytest.mark.parametrize("distill", [False, True])
@pytest.mark.parametrize("name,removed", NETS,
                         ids=[f"{n}{'-removed' if r else ''}" for n, r in NETS])
def test_estimate_mac_equals_the_estimator(name, removed, distill):
    net = presets.PRESETS[name]
    if removed:
        net = _removed(net)
    ops = native.NativeSearchOps(net, [None] * len(net), 1.0, distill=distill)
    est = ComputationEstimator(distill=distill, input_resolution=224, patch_size=14)
    assert ops.estimate_mac(net) == est(net)


@pytest.mark.parametrize("seed", SEEDS)
def test_operators_draw_the_jax_native_candidates(ops, jax_ops, seed):
    lo = 0.975 * TINY_BUDGET
    mother, father = ops.gen_random(seed), ops.gen_random(seed + 100)
    assert mother == jax_ops.gen_random(seed)
    assert father == jax_ops.gen_random(seed + 100)
    child = ops.mutate(mother, 0.3, seed)
    assert child == jax_ops.mutate(mother, 0.3, seed)
    cross = ops.crossover(mother, father, seed)
    assert cross == jax_ops.crossover(mother, father, seed)
    for net in (mother, father, child, cross):
        nd.validate(net)
        assert lo <= EST(net) <= TINY_BUDGET
        assert ops.estimate_mac(net) == EST(net)


def _score(net):
    """A deterministic stand-in for a candidate's accuracy."""
    return float(EST(net) % 997) / 10.0


@pytest.mark.parametrize("backend", ["native", "python", "auto"])
def test_evolver_populations_equal_the_jax_evolvers(jax_ops, backend):
    port = PopulationEvolver(LARGEST, SPACE, TINY_BUDGET, EST, seed=0, backend=backend)
    ref = JaxEvolver(LARGEST, SPACE, TINY_BUDGET, JAX_EST, seed=0, backend=backend)
    assert port.backend == ("python" if backend == "python" else "native")
    assert (ref.native is None) == (port.backend == "python")
    for generation in range(2):
        for ev in (port, ref):
            if generation == 0:
                ev.random_sample(12)
            else:
                ev.evolve_sample(parent_size=6, mutate_prob=0.3, mutate_size=4)
        assert [i.network_def for i in port.popu] == [i.network_def for i in ref.popu]
        for ev in (port, ref):
            for ind in ev.popu:
                ind.score = _score(ind.network_def)
            ev.update_history()
    assert [i.network_def for i in port.history_popu] == \
        [i.network_def for i in ref.history_popu]


def test_native_backend_raises_when_the_build_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    assert not native.available()
    assert "no-such-g++" in native.load_error()
    with pytest.raises(RuntimeError, match="native backend requested but unavailable"):
        PopulationEvolver(LARGEST, SPACE, TINY_BUDGET, EST, seed=0, backend="native")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.NativeSearchOps(LARGEST, SPACE, TINY_BUDGET, distill=False)
    assert PopulationEvolver(LARGEST, SPACE, TINY_BUDGET, EST, seed=0).backend == "python"
    assert os.listdir(tmp_path / "build") == []   # the failed build left nothing


def test_unknown_backend_is_refused():
    with pytest.raises(ValueError, match="backend"):
        PopulationEvolver(LARGEST, SPACE, TINY_BUDGET, EST, seed=0, backend="cuda")


_BUILDER = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, {repo!r})
    writes = []

    def audit(event, args):
        if event == "open" and (any(c in str(args[1] or "") for c in "wax+")
                                or (args[2] or 0) & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
            writes.append(str(args[0]))
        elif event in ("os.rename", "os.replace", "os.remove"):
            writes.extend(str(a) for a in args[:2])
        elif event == "subprocess.Popen":
            writes.append(" ".join(map(str, args[1])))

    sys.addaudithook(audit)
    from vit_search_torch import native
    from vit_search_torch.arch import presets
    native._BUILD_DIR = sys.argv[1]
    while not os.path.exists(sys.argv[2]):
        time.sleep(0.001)
    assert native.available(), native.load_error()
    net = presets.SUPERNET_SR_TINY_MH
    ops = native.NativeSearchOps(net, [None] * len(net), 1.0, distill=False)
    print(ops.estimate_mac(net))
    print("\\n".join(writes), file=sys.stderr)
""")


def _snapshot(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                out[name] = (os.path.getmtime(path), f.read())
    return out


def test_two_processes_building_at_once_both_load_a_whole_library(tmp_path):
    """Each build writes its own temporary file and ``os.replace``s it onto
    the hashed name: both processes load a whole library, one library is
    left, no temporary file, and nothing under ``vit_search_tpu/native/``
    is written by either (a library the JAX module keeps there, current
    against its source, is unchanged in bytes and mtime)."""
    jax_dir = os.path.join(REPO, "vit_search_tpu", "native")
    jax_lib = os.path.join(jax_dir, "libvitsearch_native.so")
    jax_src = os.path.join(jax_dir, "vitsearch_native.cpp")
    current = (os.path.exists(jax_lib)
               and os.path.getmtime(jax_lib) >= os.path.getmtime(jax_src))
    before = _snapshot(jax_dir)
    build, go = tmp_path / "build", tmp_path / "go"
    script = _BUILDER.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(build), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out.split()[0]) == EST(LARGEST)
        assert "vit_search_tpu" not in err, err
    # at least one of them compiled (both do, unless one finished first)
    assert any("g++" in line for _, err in outs for line in err.splitlines())
    assert [os.path.basename(native._lib_path())] == os.listdir(build)
    after = _snapshot(jax_dir)
    assert sorted(after) == sorted(before) or not current
    if current:
        assert after["libvitsearch_native.so"] == before["libvitsearch_native.so"]
