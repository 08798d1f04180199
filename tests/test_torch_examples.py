"""The port's five FL examples (`examples/torch_{quickstart,multi_cell,
non_iid_aou,train_flown,hier_city}.py`) on the CPU at a tiny size.

  * `torch_quickstart.one_round()` prints the JAX example's text exactly;
  * `torch_hier_city.build_spec` equals the JAX example's field by field,
    for ``--smoke`` and the default; its ``--smoke`` sweep, cut to 3
    rounds, runs its hierarchical cells as two `run_hier_many` groups
    (sync/sync on the scan engine, the async disciplines on the event
    engine) and writes its record and gallery under `tmp_path`;
  * every example runs its functions at reduced sizes with
    ``device="cpu"`` (`torch_train_flown` writes one CSV per scheme under
    ``--out``), raises without a card unless ``--device cpu`` is given,
    and imports neither `repro` nor `jax` (read from its syntax tree).
"""
from _torch_oracle import enable_x64  # noqa: F401,I001  (installs the alias first)

import argparse
import ast
import csv
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.fl import hierarchical as hier

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("quickstart", "multi_cell", "non_iid_aou", "train_flown", "hier_city")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: at these sizes more threads only oversubscribe
    the cores beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name: str):
    """An example module by file name, imported fresh."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_neither_repro_nor_jax(name):
    tree = ast.parse((EXAMPLES / f"torch_{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"repro", "jax", "jaxlib"}


@pytest.mark.parametrize("name", NAMES)
def test_example_raises_without_a_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid here")
    example = _load(f"torch_{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--out", str(tmp_path)] if name == "train_flown" else [])
    assert not list(tmp_path.iterdir())


def test_quickstart_one_round_prints_the_jax_text(capsys):
    _load("quickstart").one_round()
    want = capsys.readouterr().out
    _load("torch_quickstart").one_round()
    got = capsys.readouterr().out
    assert got == want
    assert "transmitting" in got and "round latency (eq. 9)" in got


def test_quickstart_short_sim_on_the_cpu(capsys):
    _load("torch_quickstart").short_sim("cpu", rounds=3, n_samples=96)
    lines = capsys.readouterr().out.splitlines()
    runs = [ln for ln in lines if " loss " in ln]
    assert "3-ROUND FL SIMULATION" in "\n".join(lines) and len(runs) == 2
    assert runs[0].startswith("proposed") and runs[1].startswith("random")


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_multi_cell_on_the_cpu(capsys, engine):
    _load("torch_multi_cell").compare(engine, "cpu", rounds=3)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[1] for ln in lines] == ["proposed", "random"]
    assert all(f"[{engine}]" in ln and "wall" in ln for ln in lines)


def test_non_iid_aou_on_the_cpu(capsys):
    _load("torch_non_iid_aou").run("cpu", rounds=3, n_samples=96, seeds=(0,))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["partition", "proposed", "random", "margin"]
    rows = [ln.rsplit(None, 3) for ln in lines[1:]]
    assert [r[0] for r in rows] == ["imbalanced IID", "dirichlet a=0.5", "dirichlet a=0.1"]
    assert all(np.isfinite(float(r[1])) and np.isfinite(float(r[2])) for r in rows)


def test_train_flown_writes_its_csvs(tmp_path, capsys):
    paths = _load("torch_train_flown").main(
        ["--rounds", "3", "--scheme", "random", "--device", "cpu", "--out", str(tmp_path)])
    assert [Path(p).name for p in paths] == ["mnist_random.csv"]
    with open(paths[0], newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["round", "global_loss", "accuracy", "latency_s", "cum_time_s",
                       "n_transmitted", "energy_j"]
    assert [int(r[0]) for r in rows[1:]] == [0, 1, 2]
    assert all(np.isfinite(float(r[1])) for r in rows[1:])
    assert "mnist/random: loss" in capsys.readouterr().out


def _spec_args(smoke: bool) -> argparse.Namespace:
    return argparse.Namespace(name="hier_async", seeds=2, rounds=60, target_loss=1.0,
                              smoke=smoke)


@pytest.mark.parametrize("smoke", [True, False])
def test_hier_city_spec_is_the_jax_spec(smoke):
    got = _load("torch_hier_city").build_spec(_spec_args(smoke))
    want = _load("hier_city").build_spec(_spec_args(smoke))
    names = [f.name for f in dataclasses.fields(got)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for name in names:
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_cells == want.n_cells


def test_hier_city_smoke_runs_two_groups(monkeypatch, tmp_path, capsys):
    example = _load("torch_hier_city")
    spec = dataclasses.replace(example.build_spec(_spec_args(True)), rounds=3)
    groups = []
    run_group = hier._run_hier_group

    def counted(mode, cfgs, *args, **kw):
        groups.append((mode, len(cfgs)))
        return run_group(mode, cfgs, *args, **kw)

    monkeypatch.setattr(hier, "_run_hier_group", counted)
    res = example.run(spec, "cpu", str(tmp_path))
    assert sorted(groups) == [("async", 3), ("scan", 1)]
    assert (res.out_dir / "sweep.json").exists()
    assert list((res.out_dir / "figures").glob("*.svg"))
    out = capsys.readouterr().out
    for disc in ("sync/g.sync", "sync/g.async", "async/g.sync", "async/g.async"):
        assert disc in out
    assert all(np.isfinite(h.global_loss).all() for h in res.histories)
