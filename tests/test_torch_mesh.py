"""The port's mesh with named axes (`repro_torch.core.engine.Mesh`) and the
engine on it, on the CPU.

* the class: sizes, row-major devices, ``shape``, the worker axis and its
  shard devices (the first device of each data slice), validation;
* the engine: a run on an N-D mesh (``(data=2, model=2)``, ``(model=2,
  data=2)``, ``(pod=1, data=2, model=2)``, ``(model=2, pod=2)`` with no
  ``data`` axis) equals, in every counter, every ``per_worker_*`` and the
  match buffer, the 1-D run whose data axis has the same size (``repro``
  shards the worker axis over ``data`` and replicates it over the rest);
  the dense, CSR and partitioned paths, and a session.

Counters are integers: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro_torch.core import EngineConfig, Enumerator  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from tests.test_torch_sharded import (  # noqa: E402
    KW,
    _assert_buffers_equal,
    _assert_same,
    _plans,
    _session_case,
)

CPU = torch.device("cpu")
META = torch.device("meta")

# (axes, sizes) of an N-D mesh on the CPU, and the 1-D mesh size it equals
ND_MESHES = {
    "data2_model2": (("data", "model"), (2, 2), 2),
    "model2_data2": (("model", "data"), (2, 2), 2),
    "pod1_data2_model2": (("pod", "data", "model"), (1, 2, 2), 2),
    "data4_model1": (("data", "model"), (4, 1), 4),
    "model2_pod2": (("model", "pod"), (2, 2), 2),  # no data axis: the first
}


def _nd(name) -> eng.Mesh:
    axes, sizes, _ = ND_MESHES[name]
    return eng.Mesh((CPU,) * int(np.prod(sizes)), axes, sizes)


def test_mesh_axes_and_shard_devices():
    d = [torch.device("cpu"), META, torch.device("cpu"), META]
    m = eng.Mesh(tuple(d), ("data", "model"), (2, 2))
    assert m.shape == {"data": 2, "model": 2} and m.size == 4
    assert m.shard_devices == (d[0], d[2])  # the first device of each data row
    m = eng.Mesh(tuple(d), ("model", "data"), (2, 2))
    assert m.shard_devices == (d[0], d[1])
    assert m.distinct_devices == (d[0], d[1])
    m = eng.Mesh(tuple(d), ("model", "pod"), (2, 2))
    assert eng.mesh_worker_axis(m) == "model" and m.shard_devices == (d[0], d[2])
    one = eng.Mesh((CPU, CPU, CPU))  # the 1-D default, unchanged
    assert (one.axis_names, one.axis_sizes, one.shape) == (("data",), (3,), {"data": 3})
    assert one.shard_devices == one.devices
    assert eng.mesh_signature(_nd("data2_model2")) == (
        ("data", "model"), (2, 2), ("cpu",) * 4)


@pytest.mark.parametrize("bad,match", [
    (dict(devices=(CPU,) * 4, axis_names=("data", "model")), "needs axis_sizes"),
    (dict(devices=(CPU,) * 4, axis_names=("data", "model"), axis_sizes=(2, 3)),
     "do not multiply"),
    (dict(devices=(CPU,) * 4, axis_names=("data",), axis_sizes=(2, 2)), "do not match"),
    (dict(devices=(CPU,) * 4, axis_names=("data", "data"), axis_sizes=(2, 2)),
     "do not match"),
    (dict(devices=(CPU,) * 2, axis_names=("data", "model"), axis_sizes=(2, 0)),
     "do not multiply"),
    (dict(devices=()), "at least one"),
])
def test_mesh_validation(bad, match):
    with pytest.raises(ValueError, match=match):
        eng.Mesh(**bad)


@pytest.mark.parametrize("mesh_name", sorted(ND_MESHES))
def test_nd_mesh_run_equals_the_1d_run(mesh_name):
    jplan, plan = _plans("dense")
    d = ND_MESHES[mesh_name][2]
    for kw in (dict(step_backend="jnp"), dict(step_backend="csr", use_pallas=True)):
        cfg = EngineConfig(**KW, **kw)
        want = eng.run(plan, cfg, mesh=eng.Mesh((CPU,) * d), device=CPU)
        got = eng.run(plan, cfg, mesh=_nd(mesh_name))
        _assert_same(got, want, f"{mesh_name} {kw}")
        _assert_buffers_equal(got, want, f"{mesh_name} {kw}")


def test_nd_mesh_partitioned_and_session_equal_the_1d_runs():
    _, plan = _plans("sparse_power_law")
    kw = dict(n_workers=4, expand_width=2, n_partitions=2, step_backend="partitioned")
    s1, s2 = {}, {}
    want = eng.run_partitioned(plan, EngineConfig(**kw), mesh=2, device=CPU, stats=s1)
    got = eng.run_partitioned(plan, EngineConfig(**kw), mesh=_nd("data2_model2"), stats=s2)
    _assert_same(got, want, "partitioned")
    assert s1 == s2
    idx, pat, _, _ = _session_case(seed=3)
    a = Enumerator(idx, n_workers=7, expand_width=2, mesh=2, device=CPU)
    b = Enumerator(idx, n_workers=7, expand_width=2, mesh=_nd("pod1_data2_model2"))
    assert a.config.n_workers == b.config.n_workers == 8  # snapped to the data axis
    assert b.device == CPU and b.mesh.shape == {"pod": 1, "data": 2, "model": 2}
    ra, rb = a.run(a.prepare(pat)), b.run(b.prepare(pat))
    _assert_same(rb.engine, ra.engine, "session")
