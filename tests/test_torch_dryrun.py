"""The port's dry-run and production meshes against ``repro.launch.dryrun``
and ``repro.launch.mesh``, on the CPU.

* every buildable cell (39) on both production meshes: each argument
  leaf's ``PartitionSpec`` equals ``repro``'s ``logical_to_pspec`` on the
  same leaf of ``repro``'s cell, and the bytes per device (all and
  donated) equal the numpy arithmetic over ``repro``'s leaves.  The
  ``sge`` cells go through the pack-of-one mapping of
  ``tests/test_torch_registry.py``: state fields carry the pack axis
  (logical ``None``), ``n_p`` is ``[1]``, the dense plan's storage is
  ``rows`` (``adj_bits`` a view of it, one row shorter) and the CSR plan's
  ``deg_cap`` is an int where ``repro`` has ``seg_iota``;
* the four ``sge`` cells' argument bytes per device on the single-pod mesh
  against ``repro``'s compiled ``memory_analysis.argument_size_in_bytes``
  (JAX 0.9.0 on the CPU), after those layout differences and the one
  argument XLA drops because a round never reads it (``order_valid``);
* ``--list`` prints ``repro``'s 44 lines, and ``make_production_mesh`` /
  ``describe`` give ``repro``'s meshes (a subprocess with 512 forced host
  devices);
* the command line: 88 records (78 run, 10 skipped), resuming, ``--force``,
  a failing cell's ``.err`` and exit 1, ``--save-hlo`` refused,
  ``--demo-swa``; the meshes' placeholders refused by the engine.

Bytes and specs are integers and names: exact equality.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.configs import registry as jax_registry  # noqa: E402
from repro.distributed import shardings as jax_sh  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import Enumerator, SubgraphIndex  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.data import graphgen  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import describe, make_local_mesh, make_production_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_CELLS = {c.name: c for c in jax_registry.all_cells()}
CELLS = {c.name: c for c in registry.all_cells()}
BUILDABLE = sorted(n for n, c in CELLS.items() if c.build is not None)
MESHES = {"single": make_production_mesh(multi_pod=False),
          "multi": make_production_mesh(multi_pod=True)}

# repro's compiled memory_analysis.argument_size_in_bytes per device,
# ``python -m repro.launch.dryrun --arch sge --mesh single`` (JAX 0.9.0, CPU)
REF_COMPILED = {
    "sge/sge_ppis32": 11_977_789,
    "sge/sge_graemlin32": 7_446_589,
    "sge/sge_pdbsv1": 33_237_501,
    "sge/sge_pdbsv1_csr": 16_575_133,
}
ORDER_VALID_BYTES = 64  # [p_pad = 64] bool, replicated: no round reads it


class StubMesh:
    def __init__(self, shape):
        self.shape = shape


def _is_jax_leaf(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _jax_leaves(jb, mesh) -> dict:
    """``repro``'s leaves of a cell by path: spec, shard shape and bytes
    per device on ``mesh``, by the numpy arithmetic."""
    out = {}
    for i, (log, arg) in enumerate(zip(jb.logical, jb.args)):
        paths = jax.tree_util.tree_flatten_with_path(arg)[0]
        logs = jax.tree.leaves(log, is_leaf=_is_jax_leaf)
        assert len(paths) == len(logs)
        for (p, x), lg in zip(paths, logs):
            spec = jax_sh.logical_to_pspec(lg, x.shape, mesh)
            shard = [d // math.prod(mesh.shape[a] for a in (
                () if e is None else e if isinstance(e, tuple) else (e,)))
                for d, e in zip(x.shape, tuple(spec) + (None,) * (len(x.shape) - len(spec)))]
            out[f"[{i}]{jax.tree_util.keystr(p)}"] = dict(
                spec=_spec(spec), shard_shape=shard, donated=i in jb.donate,
                bytes=math.prod(shard) * np.dtype(x.dtype).itemsize)
    return out


def _total(leaves: dict, donated_only=False) -> int:
    return sum(r["bytes"] for r in leaves.values() if r["donated"] or not donated_only)


@pytest.mark.parametrize("name", BUILDABLE)
def test_cell_specs_and_bytes_match_repro(name):
    jb = JAX_CELLS[name].build()
    for mesh_name, mesh in MESHES.items():
        rec = dryrun.run_cell(CELLS[name], mesh)
        mine = {r["path"]: r for r in rec["leaves"]}
        theirs = _jax_leaves(jb, StubMesh(mesh.shape))
        mem = rec["memory_analysis"]
        assert rec["mesh"] == mesh.shape and rec["n_devices"] == mesh.size
        want_args, want_alias = _total(theirs), _total(theirs, donated_only=True)
        if CELLS[name].arch != "sge":
            assert list(mine) == list(theirs), mesh_name
            for path, t in theirs.items():
                r = mine[path]
                assert (r["spec"], r["shard_shape"], r["bytes_per_device"], r["donated"]) == (
                    t["spec"], t["shard_shape"], t["bytes"], t["donated"]), (mesh_name, path)
            assert not any(r["view"] for r in rec["leaves"])
        else:
            want_args += _check_sge(mine, theirs, mesh_name)
        assert (mem["argument_size_in_bytes"], mem["alias_size_in_bytes"]) == (
            want_args, want_alias), mesh_name
        assert rec["not_computed"]["keys"] and "cost_analysis" not in rec


def _check_sge(mine: dict, theirs: dict, mesh_name: str) -> int:
    """The pack-of-one layout against ``repro``'s leaves; returns the port's
    bytes per device minus ``repro``'s arithmetic."""
    delta = 0
    for path, t in theirs.items():
        if path.startswith("[1]"):  # state: the pack axis in front
            r = mine[path]
            assert (r["spec"], r["shard_shape"], r["bytes_per_device"]) == (
                [None] + t["spec"], [1] + t["shard_shape"], t["bytes"]), (mesh_name, path)
        elif path == "[0].seg_iota":  # an int in the port: no storage
            assert t["spec"] == [None] and "[0].deg_cap" not in mine
            delta -= t["bytes"]
        elif path == "[0].n_p":  # one per pack lane
            assert (mine[path]["spec"], mine[path]["bytes_per_device"]) == ([None], t["bytes"])
        elif path == "[0].adj_bits":  # a view of rows, one row shorter
            adj, rows = mine[path], mine["[0].rows"]
            assert adj["view"] and adj["bytes_per_device"] == 0 and adj["spec"] == t["spec"]
            assert rows["spec"] == [None, t["spec"][-1]]
            row_bytes = rows["shard_shape"][1] * 4
            assert rows["bytes_per_device"] == t["bytes"] + row_bytes, mesh_name
            delta += row_bytes
        else:
            r = mine[path]
            assert (r["spec"], r["bytes_per_device"]) == (t["spec"], t["bytes"]), path
    assert set(mine) - set(theirs) <= {"[0].rows"}
    return delta


@pytest.mark.parametrize("name", sorted(REF_COMPILED))
def test_sge_bytes_match_repro_compiled(name):
    """The port's single-mesh argument bytes = ``repro``'s compiled figure
    + ``order_valid`` (XLA drops it, the port counts it) + one row of
    ``rows`` per device (dense; the CSR's ``seg_iota`` is dropped by XLA and
    absent from the port)."""
    rec = dryrun.run_cell(CELLS[name], MESHES["single"])
    leaves = {r["path"]: r for r in rec["leaves"]}
    extra = ORDER_VALID_BYTES
    if "[0].rows" in leaves:
        extra += leaves["[0].rows"]["shard_shape"][1] * 4
    assert leaves["[0].order_valid"]["bytes_per_device"] == ORDER_VALID_BYTES
    assert rec["memory_analysis"]["argument_size_in_bytes"] == REF_COMPILED[name] + extra


_REPRO_SCRIPT = r"""
import contextlib, io, json, sys
import repro.launch.dryrun as d  # sets XLA_FLAGS before JAX starts
from repro.launch.mesh import describe, make_production_mesh
buf = io.StringIO()
sys.argv = ["dryrun", "--list"]
with contextlib.redirect_stdout(buf):
    rc = d.main()
meshes = []
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    meshes.append(dict(describe=describe(m), shape=dict(m.shape), names=list(m.axis_names),
                       n=int(m.devices.size)))
print(json.dumps(dict(rc=rc, list=buf.getvalue(), meshes=meshes)))
"""


def test_list_and_meshes_match_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    jax_out = subprocess.run([sys.executable, "-c", _REPRO_SCRIPT], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
    assert jax_out.returncode == 0, jax_out.stderr[-2000:]
    want = json.loads(jax_out.stdout.strip().splitlines()[-1])
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 == want["rc"], out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines == want["list"].splitlines()
    assert len(lines) == 44 and sum("SKIP (" in ln for ln in lines) == 5
    for multi, w in zip((False, True), want["meshes"]):
        m = make_production_mesh(multi_pod=multi)
        assert (describe(m), m.shape, list(m.axis_names), m.size) == (
            w["describe"], w["shape"], w["names"], w["n"])
        assert set(m.devices) == {torch.device("meta")}
    assert want["meshes"][0]["describe"] == "mesh{'data': 16, 'model': 16} over 256 devices"


def test_cli_writes_resumes_and_records_failures(tmp_path, capsys, monkeypatch):
    out = str(tmp_path / "dr")
    assert dryrun.main(["--out", out]) == 0
    recs = {}
    for mesh_name in ("single", "multi"):
        for f in sorted(os.listdir(os.path.join(out, mesh_name))):
            with open(os.path.join(out, mesh_name, f)) as fh:
                recs[(mesh_name, f)] = json.load(fh)
    assert len(recs) == 88
    run = [r for r in recs.values() if "memory_analysis" in r]
    skipped = [r for r in recs.values() if r.get("skipped")]
    assert (len(run), len(skipped)) == (78, 10)
    assert all(r["skip_reason"] and r["shape"] == "long_500k" for r in skipped)
    assert {tuple(r["mesh"].values()) for r in run} == {(16, 16), (2, 16, 16)}
    text = capsys.readouterr().out
    assert "=== single: mesh{'data': 16, 'model': 16} over 256 devices ===" in text
    assert "done; 0 failures" in text
    # resumed: every record kept; --force rebuilds one
    assert dryrun.main(["--out", out, "--mesh", "single"]) == 0
    assert capsys.readouterr().out.count("[cached]") == 39
    assert dryrun.main(["--out", out, "--mesh", "single", "--arch", "din", "--force"]) == 0
    text = capsys.readouterr().out
    assert "[cached]" not in text and text.count("  ok: ") == 4
    # a failing cell: its .err, the rest recorded, exit 1

    def boom():
        raise RuntimeError("no such shape")

    cell = registry.get("gcn-cora").cells["molecule"]
    monkeypatch.setattr(cell, "build", boom)
    assert dryrun.main(["--out", out, "--mesh", "multi", "--arch", "gcn-cora",
                        "--force"]) == 1
    err = os.path.join(out, "multi", "gcn-cora__molecule.json.err")
    assert "no such shape" in open(err).read()
    assert "1 failures" in capsys.readouterr().out


def test_cli_refuses_save_hlo_and_records_demo_swa(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--save-hlo"])
    assert e.value.code == 2 and "lowers nothing" in capsys.readouterr().err
    assert dryrun.main(["--demo-swa", "--out", str(tmp_path)]) == 0
    rec = json.load(open(tmp_path / "demo_swa_long500k.json"))
    assert (rec["window"], rec["kv_block"], rec["mesh"]) == (8192, 4096,
                                                             {"data": 16, "model": 16})
    # tokens and labels [1, 524288] int32: a batch of 1 does not divide, replicated
    assert rec["batch_bytes_per_device"] == 2 * 524288 * 4
    assert rec["params_bytes_per_device"] + rec["batch_bytes_per_device"] == \
        rec["memory_analysis"]["argument_size_in_bytes"] == dryrun.argument_bytes(rec["leaves"])
    assert "FLOP" in rec["not_computed"]["why"]


def test_placeholder_meshes_run_no_engine():
    g = graphgen.random_graph(12, 20, n_labels=2, seed=1)
    with pytest.raises(ValueError, match="meta placeholders"):
        Enumerator(SubgraphIndex.build(g), mesh=make_production_mesh())
    with pytest.raises(ValueError, match="meta placeholders"):
        eng.coerce_mesh(2, "meta")
    assert make_local_mesh(device="cpu").shape == {"data": 1, "model": 1}
    assert make_local_mesh(("data",), device="cpu").devices == (torch.device("cpu"),)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_local_mesh()
