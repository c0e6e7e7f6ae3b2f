"""The port's elastic reshard against ``repro.checkpoint.reshard``, on the
CPU.

``repro``'s ``place`` runs in a subprocess on four forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) over a ``(data=2,
model=2)`` mesh, a 1-D ``data`` mesh of 4 and a ``(1, 1)`` mesh; the port's
``place`` lays the same host tree (fp32, bf16 and int32 leaves, a dimension
that does not divide, a scalar) over ``Mesh((cpu,) * 4)`` of those shapes.
Each device's shard must have ``repro``'s index (slices) and data, bit for
bit, and the shard shape the dry-run reports (``named_sharding(...).
shard_shape``); ``gather`` returns the tree, and the resident bytes are the
mesh's devices times the dry-run's bytes per device.  The checkpoint path
(``store.save`` → ``store.restore`` without ``like_*`` → ``place``) and
``tests/test_checkpoint.py::test_elastic_reshard_roundtrip`` run on the
port too.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro_torch.checkpoint import gather, place, store  # noqa: E402
from repro_torch.checkpoint.reshard import PlacedLeaf  # noqa: E402
from repro_torch.core.engine import Mesh  # noqa: E402
from repro_torch.distributed.shardings import named_sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.train.tree import leaves, leaves_with_paths, unflatten_like  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOGICAL = {
    "w": ("batch", "tensor"),  # [8, 6]: both axes
    "emb": ("tensor", "fsdp"),  # bf16 [4, 10]
    "odd": ("fsdp", None),  # [5, 3]: 5 does not divide
    "ids": (None, "batch"),  # int32 [3, 4]
    "b": {"s": ()},  # a scalar
}
FLAT_LOGICAL = {k: v for k, v in LOGICAL.items() if k != "b"} | {"s": ()}
SHAPES = {"w": (8, 6), "emb": (4, 10), "odd": (5, 3), "ids": (3, 4), "s": ()}
MESHES = {
    "2x2": ((2, 2), ("data", "model")),
    "4": ((4,), ("data",)),
    "1x1": ((1, 1), ("data", "model")),
}


def _host_numpy():
    rng = np.random.default_rng(11)
    return {
        "w": rng.normal(size=SHAPES["w"]).astype(np.float32),
        "emb": rng.normal(size=SHAPES["emb"]).astype(ml_dtypes.bfloat16),
        "odd": rng.normal(size=SHAPES["odd"]).astype(np.float32),
        "ids": rng.integers(-9, 9, size=SHAPES["ids"]).astype(np.int32),
        "b": {"s": np.float32(2.5)},
    }


def _to_torch(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(x.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bits(t: torch.Tensor) -> list:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).reshape(-1).tolist()


_REPRO_SCRIPT = r"""
import json, sys
import jax, ml_dtypes, numpy as np
from repro.checkpoint.reshard import place

host = {k: v for k, v in np.load(sys.argv[1]).items()}
host["emb"] = host["emb"].view(ml_dtypes.bfloat16)
tree = {"w": host["w"], "emb": host["emb"], "odd": host["odd"], "ids": host["ids"],
        "b": {"s": host["s"]}}
logical, meshes = json.loads(sys.argv[2])
out = {}
for name, (shape, axes) in meshes.items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(axes), devices=jax.devices()[:n])
    pos = {d.id: i for i, d in enumerate(mesh.devices.reshape(-1))}
    logical_tree = {k: tuple(v) for k, v in logical.items() if k != "b"}
    logical_tree["b"] = {"s": ()}
    placed = place(tree, logical_tree, mesh)
    rec = {}
    for key, arr in (("w", placed["w"]), ("emb", placed["emb"]), ("odd", placed["odd"]),
                     ("ids", placed["ids"]), ("s", placed["b"]["s"])):
        shards = []
        for s in arr.addressable_shards:
            data = np.asarray(s.data)
            if data.dtype == ml_dtypes.bfloat16:
                data = data.view(np.int16)
            shards.append(dict(pos=pos[s.device.id], data=data.reshape(-1).tolist(),
                               index=[[sl.start, sl.stop] for sl in s.index]))
        rec[key] = dict(spec=[list(e) if isinstance(e, tuple) else e for e in arr.sharding.spec],
                        shards=sorted(shards, key=lambda r: r["pos"]))
    out[name] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_placed(tmp_path_factory):
    host = _host_numpy()
    path = tmp_path_factory.mktemp("reshard") / "host.npz"
    np.savez(path, w=host["w"], emb=host["emb"].view(np.int16), odd=host["odd"],
             ids=host["ids"], s=host["b"]["s"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    logical = {k: list(v) for k, v in LOGICAL.items() if k != "b"}
    proc = subprocess.run([sys.executable, "-c", _REPRO_SCRIPT, str(path),
                           json.dumps([logical, MESHES])], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_mesh(name) -> Mesh:
    shape, axes = MESHES[name]
    return Mesh((CPU,) * int(np.prod(shape)), axes, shape)


def _host_tree() -> dict:
    h = _host_numpy()
    return {k: _to_torch(v) for k, v in h.items() if k != "b"} | {"b": {"s": _to_torch(
        h["b"]["s"])}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_place_matches_repro(repro_placed, mesh_name):
    mesh, host = _port_mesh(mesh_name), _host_tree()
    placed = place(host, LOGICAL, mesh)
    got = {"w": placed["w"], "emb": placed["emb"], "odd": placed["odd"],
           "ids": placed["ids"], "s": placed["b"]["s"]}
    for key, want in repro_placed[mesh_name].items():
        leaf = got[key]
        assert isinstance(leaf, PlacedLeaf) and leaf.shape == SHAPES[key]
        assert [list(e) if isinstance(e, tuple) else e for e in leaf.sharding.spec] == \
            want["spec"], key
        assert len(leaf.shards) == mesh.size == len(want["shards"])
        index = leaf.sharding.device_index(leaf.shape)
        for k, (shard, w) in enumerate(zip(leaf.shards, want["shards"])):
            assert w["pos"] == k
            assert [[s.start, s.stop] for s in index[k]] == w["index"], (key, k)
            assert _bits(shard) == w["data"], (key, k)
            assert shard.dtype == leaf.dtype and shard.is_contiguous()
            assert tuple(shard.shape) == named_sharding(
                FLAT_LOGICAL[key], leaf.shape, mesh).shard_shape(leaf.shape)
        # each shard is a copy in storage of its own
        ptrs = {s.untyped_storage().data_ptr() for s in leaf.shards}
        assert len(ptrs) == mesh.size
    back = gather(placed)
    for (p, a), (_, b) in zip(leaves_with_paths(back), leaves_with_paths(host)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b), p
    # resident bytes: the mesh's devices times the dry-run's bytes per device
    records = dryrun.leaf_records((LOGICAL,), (host,), mesh)
    assert sum(x.nbytes for x in leaves(placed, lambda x: isinstance(x, PlacedLeaf))) == \
        mesh.size * dryrun.argument_bytes(records)


def test_checkpoint_restore_then_place(tmp_path):
    """``store.save`` → ``store.restore`` (no ``like_*``: CPU tensors by
    path, bf16 included) → ``place`` on a local mesh and on ``(2, 2)``
    shards → ``gather``: the saved tree, bit for bit."""
    host = _host_tree()
    store.save(str(tmp_path / "ck"), 3, host)
    step, flat, _ = store.restore(str(tmp_path / "ck"), 3)
    assert step == 3 and flat["['params']['emb']"].dtype == torch.bfloat16
    tree = unflatten_like(host, [flat["['params']" + p] for p, _ in leaves_with_paths(host)])
    for mesh in (make_local_mesh(device="cpu"), _port_mesh("2x2")):
        placed = place(tree, LOGICAL, mesh)
        if mesh.size == 1:  # one device: every leaf whole
            assert all(s.shards[0].shape == torch.Size(s.shape) for s in
                       leaves(placed, lambda x: isinstance(x, PlacedLeaf)))
        for (p, a), (_, b) in zip(leaves_with_paths(gather(placed)), leaves_with_paths(host)):
            assert _bits(a) == _bits(b), p
    # a leaf that is not a tensor passes through with a None logical
    assert place({"n": 7, "x": torch.ones(2)}, {"n": None, "x": (None,)},
                 _port_mesh("4"))["n"] == 7


def test_elastic_reshard_roundtrip(tmp_path):
    """``tests/test_checkpoint.py::test_elastic_reshard_roundtrip`` on the
    port (its in-place restore into ``like_params``)."""
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": {"x": torch.ones(4)}}
    base = str(tmp_path / "ck")
    store.save(base, 3, params)
    _, host, _ = store.restore(base, 3, like_params={k: v for k, v in params.items()})
    placed = place(host, {"w": ("batch", None), "b": {"x": (None,)}},
                   make_local_mesh(("data", "model"), device="cpu"))
    assert torch.equal(gather(placed["w"]), params["w"])
    assert gather(placed["w"], device="cpu").device == CPU
