"""The port's logical-axis shardings against ``repro.distributed.shardings``,
on the CPU.

* ``logical_to_pspec`` against ``repro``'s on stub meshes ``(1, 1)``,
  ``(2, 2)``, ``(16, 16)`` (``data``, ``model``) and ``(2, 16, 16)``
  (``pod``, ``data``, ``model``), and on the port's own meshes of those
  shapes: every rule name, ``None`` and an unknown name, one and two
  dimensions, sizes that divide and that do not, axes already used,
  scalars, custom ``rules``;
* ``tests/test_shardings.py`` on the port, and the port's additions:
  ``PartitionSpec`` as a tuple, ``NamedSharding``'s shard shapes and
  device blocks, ``tree_shardings`` over the port's trees (``None``
  logicals beside leaves that are not tensors), the identity
  ``constraint``.

Specs are compared as tuples, exactly.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.distributed import shardings as jax_sh  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import extend  # noqa: E402
from repro_torch.core.engine import Mesh  # noqa: E402
from repro_torch.distributed import shardings as sh  # noqa: E402
from repro_torch.distributed.shardings import P  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.train.tree import leaves_up_to  # noqa: E402

META = torch.device("meta")


class StubMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
NAMES = [n for n in jax_sh._DEFAULT_RULES if n is not None] + [None, "unknown"]
DIMS = [1, 2, 3, 16, 48, 100, 256, 512, 1024]
CUSTOM = {"batch": ("model",), "tensor": ("data", "model"), "x": ("pod",), "y": ("nope",)}


def _port_mesh(shape):
    return Mesh((META,) * int(torch.tensor(list(shape.values())).prod()),
                tuple(shape), tuple(shape.values()))


def _cases():
    one = [((n,), (d,)) for n in NAMES for d in DIMS]
    two = [((a, b), (d, e)) for a, b in itertools.product(NAMES, NAMES)
           for d, e in [(256, 256), (32, 48), (100, 512), (1024, 3)]]
    return one + two + [((), ()), ((None, None, None), (4, 5, 6))]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_logical_to_pspec_matches_repro(mesh_name):
    shape = MESHES[mesh_name]
    stub, port = StubMesh(shape), _port_mesh(shape)
    assert port.shape == shape
    sharded = 0
    for logical, dims in _cases():
        want = tuple(jax_sh.logical_to_pspec(logical, dims, stub))
        assert tuple(sh.logical_to_pspec(logical, dims, stub)) == want, (logical, dims)
        assert tuple(sh.logical_to_pspec(logical, dims, port)) == want, (logical, dims)
        rules_want = tuple(jax_sh.logical_to_pspec(logical, dims, stub, CUSTOM))
        assert tuple(sh.logical_to_pspec(logical, dims, port, CUSTOM)) == rules_want
        sharded += any(e is not None for e in want)
    assert len(_cases()) == 492
    assert (sharded == 0) == (mesh_name == "1x1"), sharded
    assert sh._DEFAULT_RULES == jax_sh._DEFAULT_RULES


def test_axis_mapping_shapes():
    """``tests/test_shardings.py::test_axis_mapping_shapes`` on the port."""
    mesh = StubMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.logical_to_pspec(("batch", None, "tensor"), (256, 7, 4096), mesh) == \
        P(("pod", "data"), None, "model")
    assert sh.logical_to_pspec(("batch",), (100,), mesh) == P(None)
    assert sh.logical_to_pspec(("tensor",), (48,), mesh) == P("model")
    assert sh.logical_to_pspec(("edge",), (1024,), mesh) == P(("pod", "data", "model"))
    spec = sh.logical_to_pspec(("batch", "fsdp"), (32, 32), mesh)
    assert spec[0] == ("pod", "data") and spec[1] is None  # pod/data already consumed
    # a mesh axis left over for a later dimension once the first fell back
    spec = sh.logical_to_pspec(("batch", "fsdp"), (100, 64), mesh)
    assert spec == P(None, ("pod", "data"))
    with pytest.raises(ValueError, match="do not match"):
        sh.logical_to_pspec(("batch",), (2, 3), mesh)


def test_divisibility_fallback_and_scalar_on_a_local_mesh():
    mesh = make_local_mesh(("data", "model"), device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert sh.logical_to_pspec(("batch", "tensor"), (8, 16), mesh) == P(None, None)
    s = sh.named_sharding((), (), mesh)
    assert s.spec == P() and s.shard_shape(()) == () and s.device_index(()) == [()]


def test_partition_spec_is_a_tuple():
    assert P() == () and P(None, "model") == (None, "model")
    assert P(("pod", "data"), None)[0] == ("pod", "data")
    assert repr(P(None, "model")) == "PartitionSpec(None, 'model')"
    assert isinstance(P("data"), tuple) and hash(P("data")) == hash(("data",))


def test_named_sharding_blocks():
    """Shard shapes and each device's block, the first axis of a tuple
    entry major, in mesh order."""
    mesh = Mesh((META,) * 8, ("pod", "data", "model"), (2, 2, 2))
    s = sh.NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert s.shard_shape((8, 3, 6)) == (2, 3, 3)
    idx = s.device_index((8, 3, 6))
    assert len(idx) == 8
    # device (pod, data, model) = flat 4·pod + 2·data + model
    for flat, (p, d, m) in enumerate(itertools.product(range(2), repeat=3)):
        block = 2 * p + d
        assert idx[flat] == (slice(2 * block, 2 * block + 2), slice(None),
                             slice(3 * m, 3 * m + 3))
    # a spec shorter than the shape: the rest replicated
    short = sh.NamedSharding(mesh, P("model"))
    assert short.shard_shape((4, 5)) == (2, 5)
    with pytest.raises(ValueError, match="more entries"):
        sh.NamedSharding(mesh, P("model", None)).shard_shape((4,))


def test_tree_shardings_structure():
    """``tests/test_shardings.py::test_tree_shardings_structure`` on the
    port, with the port's trees."""
    mesh = make_local_mesh(("data", "model"), device="cpu")
    abstract = {"a": torch.empty((4, 4), device=META),
                "b": (torch.empty((2,), dtype=torch.int32, device=META),)}
    logical = {"a": ("batch", None), "b": ((None,),)}
    out = sh.tree_shardings(logical, abstract, mesh)
    assert set(out) == {"a", "b"} and isinstance(out["b"], tuple)
    assert out["a"].spec == P(None, None) and out["b"][0].spec == P(None)
    # scalars and empty logicals are leaves
    out = sh.tree_shardings({"s": ()}, {"s": torch.empty((), device=META)}, mesh)
    assert out["s"].spec == P()


def test_tree_shardings_on_plan_trees():
    """The ``sge`` CSR plan: a NamedTuple whose ``deg_cap`` / ``p_pad`` /
    ``n_p_max`` are ints with a ``None`` logical; on the single-pod mesh the
    bitmap words shard over ``model``."""
    mesh = Mesh((META,) * 256, ("data", "model"), (16, 16))
    plan = extend.abstract_csr_plan_arrays(33067, 1152, 64, 8, nnz=1000, deg_cap=512)
    out = sh.tree_shardings(extend.CSR_PLAN_LOGICAL, plan, mesh)
    assert type(out) is extend.CsrPlanArrays
    assert out.deg_cap is None and out.p_pad is None and out.n_p_max is None
    assert out.dom_bits.spec == P(None, "model")
    assert out.dom_bits.shard_shape(plan.dom_bits.shape) == (64, 72)
    assert out.indices.spec == P(None)
    with pytest.raises(ValueError, match="no logical axes"):
        sh.tree_shardings({"a": None}, {"a": torch.empty(3, device=META)}, mesh)


def test_tree_shardings_on_every_cell_tree():
    """Every buildable cell's argument trees take shardings leaf for leaf
    (the ``sge`` plans' ints give ``None``)."""
    mesh = Mesh((META,) * 512, ("pod", "data", "model"), (2, 16, 16))
    for cell in registry.all_cells(include_skipped=False):
        b = cell.build()
        for log, arg in zip(b.logical, b.args):
            out = sh.tree_shardings(log, arg, mesh)
            got = leaves_up_to(log, out, sh.is_logical_leaf)
            xs = leaves_up_to(log, arg, sh.is_logical_leaf)
            assert len(got) == len(xs)
            for s, x in zip(got, xs):
                assert (s is None) == (not isinstance(x, torch.Tensor)), cell.name


def test_is_logical_leaf():
    assert sh.is_logical_leaf(()) and sh.is_logical_leaf(None)
    assert sh.is_logical_leaf(("batch", None)) and sh.is_logical_leaf((None,))
    assert not sh.is_logical_leaf((("batch",),)) and not sh.is_logical_leaf({"a": ()})
    assert not sh.is_logical_leaf(extend.PLAN_LOGICAL)  # a NamedTuple is a node


def test_constraint_is_the_identity():
    x = torch.arange(6).reshape(2, 3)
    assert sh.constraint(x, ("batch", "tensor")) is x
    assert sh.constraint(x, ("batch", "tensor"), _port_mesh(MESHES["2x2"])) is x
