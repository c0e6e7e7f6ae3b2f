"""The port's checkpoints and token store against ``repro``'s:
``repro_torch.checkpoint.store`` (round trips, GC, async writes, aborted
writes, checkpoints crossing between the packages in both directions,
``TrainLoop`` restarts) and ``repro_torch.data.tokens``.

Values cross exactly: a checkpoint holds the bits it was given, so every
comparison here is exact (bf16 by its bits).
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port needs PyTorch; CI without it skips

from repro.checkpoint import store as jax_store  # noqa: E402
from repro.data import tokens as jax_tokens  # noqa: E402
from repro.train import optimizer as jax_opt  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.tree import leaves_with_paths  # noqa: E402


def _params():
    return {"w": torch.arange(6.0).reshape(2, 3), "b": {"x": torch.ones(4)}}


def _mixed(rng):
    """A tree of fp32 and bf16 leaves (as numpy: fp32, ml_dtypes bfloat16)."""
    return {"embed": rng.normal(size=(5, 3)).astype(jnp.bfloat16),
            "layers": {"wq": rng.normal(size=(2, 3, 2)).astype(np.float32),
                       "g1": rng.normal(size=(2, 3)).astype(jnp.bfloat16)},
            "lm_head": rng.normal(size=(3, 5)).astype(np.float32)}


def _as_torch(tree):
    def conv(a):
        if isinstance(a, dict):
            return {k: conv(x) for k, x in a.items()}
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return conv(tree)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bf16, or two-byte records, as uint16), from either
    package."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" or x.dtype.kind == "V" else x


def _assert_same_trees(got, want):
    a, b = leaves_with_paths(got), leaves_with_paths(want)
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=k)


# ---------------------------------------------------------------------------
# the store on its own (tests/test_checkpoint.py on the port)
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    base = str(tmp_path / "ck")
    params = _params()
    params["b"]["y"] = torch.randn(3, 2).bfloat16()
    state = opt.init(params)
    state.mu["w"].fill_(0.5)
    store.save(base, 7, params, state)
    like = {"w": torch.zeros(2, 3), "b": {"x": torch.zeros(4),
                                          "y": torch.zeros(3, 2, dtype=torch.bfloat16)}}
    step, p2, o2 = store.restore(base, 7, like_params=like, like_opt=opt.init(like))
    assert step == 7
    _assert_same_trees(p2, params)
    _assert_same_trees(o2, state)
    assert isinstance(o2, opt.AdamWState) and o2.step.dtype == torch.int32
    assert p2["b"]["y"].dtype == torch.bfloat16
    # without a structure: the flat dict keyed by path
    _, flat, none = store.restore(base, 7)
    assert none is None
    assert sorted(flat) == sorted(k for k, _ in leaves_with_paths(
        {"params": params, "opt_state": state}))
    assert flat["['params']['b']['y']"].dtype == torch.bfloat16


def test_restore_copies_into_the_like_leaves(tmp_path):
    """A resumed run holds one copy of its state: each leaf is copied into
    its ``like`` tensor (same storage), and a ``like`` leaf of another dtype
    or shape is replaced by a tensor in the manifest's dtype."""
    base = str(tmp_path / "ck")
    params = _params()
    params["b"]["y"] = torch.randn(3, 2).bfloat16()
    state = opt.init(params)
    state.nu["w"].fill_(0.25)
    store.save(base, 3, params, state)
    like = {"w": torch.zeros(2, 3), "b": {"x": torch.zeros(4),
                                          "y": torch.zeros(3, 2, dtype=torch.bfloat16)}}
    like_opt = opt.init(like)
    ptrs = {k: v.data_ptr() for k, v in leaves_with_paths({"p": like, "o": like_opt})}
    _, p2, o2 = store.restore(base, 3, like_params=like, like_opt=like_opt)
    got = dict(leaves_with_paths({"p": p2, "o": o2}))
    assert {k: v.data_ptr() for k, v in got.items()} == ptrs
    assert p2["w"] is like["w"] and o2.nu["w"] is like_opt.nu["w"]
    _assert_same_trees(p2, params)
    _assert_same_trees(o2, state)
    # a like leaf that does not match: the stored leaf, in its own dtype
    other = {"w": torch.zeros(2, 3, dtype=torch.float64), "b": {"x": torch.zeros(5),
                                                              "y": torch.zeros(3, 2)}}
    _, p3, _ = store.restore(base, 3, like_params=other)
    _assert_same_trees(p3, params)
    assert other["w"].dtype == torch.float64 and not other["w"].any()


def test_restore_latest_and_gc(tmp_path):
    base = str(tmp_path / "ck")
    params = _params()
    for s in (1, 2, 3, 4):
        store.save(base, s, params, keep=2)
    assert store.list_steps(base) == [3, 4]
    step, p2, _ = store.restore_latest(base, like_params=params)
    assert step == 4
    assert store.restore_latest(str(tmp_path / "none")) is None


def test_async_save_snapshots_before_returning(tmp_path):
    base = str(tmp_path / "ck")
    params = _params()
    want = params["w"].clone()
    store.save(base, 1, params, async_write=True)
    params["w"].add_(100.0)  # training goes on in place
    store.wait_for_writes()
    assert store.list_steps(base) == [1]
    _, p2, _ = store.restore(base, 1, like_params=params)
    assert torch.equal(p2["w"], want)


def test_aborted_write_ignored(tmp_path):
    base = str(tmp_path / "ck")
    params = _params()
    store.save(base, 1, params)
    # simulate crash: step dir without manifest
    broken = os.path.join(base, "step_00000009")
    os.makedirs(broken)
    with open(os.path.join(broken, "arrays.npz"), "wb") as f:
        f.write(b"junk")
    assert store.list_steps(base) == [1]
    assert store.restore_latest(base, like_params=params)[0] == 1


# ---------------------------------------------------------------------------
# checkpoints crossing between the packages
# ---------------------------------------------------------------------------

def _entries(path: str) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {i.filename: zf.read(i.filename) for i in zf.infolist()}


def test_checkpoint_format_is_repros(tmp_path, rng):
    """The same tree saved by both packages: the same npz entries, byte for
    byte (keys, npy headers with ``'<V2'`` for bf16, data), and the same
    manifest but for its time."""
    tree = _mixed(rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    jax_store.save(str(tmp_path / "jax"), 3, jparams, jax_opt.init(jparams))
    params = _as_torch(tree)
    store.save(str(tmp_path / "port"), 3, params, opt.init(params))
    d = "step_00000003"
    mine = _entries(str(tmp_path / "port" / d / "arrays.npz"))
    theirs = _entries(str(tmp_path / "jax" / d / "arrays.npz"))
    assert list(mine) == list(theirs)
    assert "['params']['layers']['wq'].npy" in mine and "['opt_state'].step.npy" in mine
    assert "['opt_state'].mu['embed'].npy" in mine
    for k in mine:
        assert mine[k] == theirs[k], k
    m1, m2 = (json.load(open(tmp_path / p / d / "manifest.json")) for p in ("port", "jax"))
    del m1["time"], m2["time"]
    assert m1 == m2
    assert m1["leaves"]["['params']['embed']"]["dtype"] == "bfloat16"
    assert m1["process_count"] == 1


def test_repro_checkpoint_restores_in_the_port(tmp_path, rng):
    """``repro`` → port: fp32 and bf16 leaves come back in their dtypes
    (``repro``'s own restore hands bf16 back as raw two-byte records)."""
    tree = _mixed(rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jax_opt.init(jparams)
    jstate = jstate._replace(mu=jax.tree.map(lambda m: m + 0.25, jstate.mu), step=jnp.int32(5))
    jax_store.save(str(tmp_path), 5, jparams, jstate)
    like = _as_torch(jax.tree.map(np.zeros_like, tree))
    step, params, state = store.restore(str(tmp_path), 5, like_params=like,
                                        like_opt=opt.init(like))
    assert step == 5
    _assert_same_trees(params, _as_torch(tree))
    assert params["embed"].dtype == torch.bfloat16 and params["lm_head"].dtype == torch.float32
    assert int(state.step) == 5
    assert all(torch.equal(m, torch.full_like(m, 0.25)) for _, m in leaves_with_paths(state.mu))
    assert jax_store.restore(str(tmp_path), 5)[1]["['params']['embed']"].dtype == np.dtype("V2")


def test_port_checkpoint_restores_in_repro(tmp_path, rng):
    """Port → ``repro``: fp32 equal; bf16 compared by bits (``repro``'s
    restore gives two-byte records)."""
    tree = _mixed(rng)
    params = _as_torch(tree)
    store.save(str(tmp_path), 2, params, opt.init(params))
    jlike = jax.tree.map(jnp.asarray, tree)
    step, jp, jo = jax_store.restore(str(tmp_path), 2, like_params=jlike,
                                     like_opt=jax_opt.init(jlike))
    assert step == 2 and int(jo.step) == 0
    for (path, mine), theirs in zip(leaves_with_paths(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(_bits(mine), _bits(theirs), err_msg=path)


def test_trainer_restart_from_checkpoint(tmp_path):
    """Kill-and-restart: the loop resumes from the saved step
    (``tests/test_checkpoint.py::test_trainer_restart_from_checkpoint``)."""
    from repro_torch.train.trainer import LoopConfig, TrainLoop, make_train_step

    cfg = opt.AdamWConfig(lr=0.3, warmup_steps=0, total_steps=20, weight_decay=0.0)

    def loss_fn(params, batch):
        loss = torch.sum((params["w"] - batch) ** 2)
        return loss, {"loss": loss}

    step_fn = make_train_step(loss_fn, cfg)
    data = [torch.tensor([1.0, 2.0, 3.0])] * 40
    ckdir = str(tmp_path / "ck")

    params = {"w": torch.zeros(3)}
    loop1 = TrainLoop(step_fn, LoopConfig(total_steps=10, checkpoint_every=5, log_every=100),
                      ckpt_dir=ckdir, log=lambda *_: None)
    loop1.run(params, opt.init(params), iter(data))
    assert store.list_steps(ckdir)[-1] == 10

    # "restart": fresh params, loop resumes from step 10's weights
    params = {"w": torch.zeros(3)}
    msgs = []
    loop2 = TrainLoop(step_fn, LoopConfig(total_steps=20, checkpoint_every=5, log_every=100),
                      ckpt_dir=ckdir, log=msgs.append)
    p2, o2, hist = loop2.run(params, opt.init(params), iter(data))
    assert any("restored checkpoint at step 10" in m for m in msgs)
    assert p2["w"] is params["w"]  # restored and trained in place
    assert int(o2.step) == 20
    # loss must keep decreasing from the restored point
    assert hist[-1] < hist[0]
    assert hist[-1] < 2.0


# ---------------------------------------------------------------------------
# the token store
# ---------------------------------------------------------------------------

def test_write_shards_files_equal_repros(tmp_path, rng):
    stream = rng.integers(0, 1000, 10_000).astype(np.int32)
    assert tokens.write_shards(stream, str(tmp_path / "p"), shard_tokens=3000) == 4
    assert jax_tokens.write_shards(stream, str(tmp_path / "j"), shard_tokens=3000) == 4
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert "tokens_manifest.json" in names
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


def test_token_loader_matches_repro(tmp_path, rng):
    """Batches across shard boundaries and epochs, and the cursor resume."""
    stream = rng.integers(0, 1000, 5_000).astype(np.int32)
    tokens.write_shards(stream, str(tmp_path), shard_tokens=700)
    mine = tokens.TokenLoader(str(tmp_path), batch=4, seq=64, seed=1)
    theirs = jax_tokens.TokenLoader(str(tmp_path), batch=4, seq=64, seed=1)
    assert (mine.samples_per_epoch, mine.steps_per_epoch) == (theirs.samples_per_epoch,
                                                              theirs.steps_per_epoch)
    it, jit_ = mine.batches(), theirs.batches()
    cursors = []
    for _ in range(2 * mine.steps_per_epoch + 3):  # into the third epoch
        (b, cur), (jb, jcur) = next(it), next(jit_)
        assert cur.to_dict() == jcur.to_dict()  # each package has its own Cursor
        cursors.append(cur)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k], jb[k])
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert cursors[-1].epoch == 2
    # resume: a new loader from a mid-stream cursor gives the same next batch
    b_next, _ = next(it)
    resumed, _ = next(tokens.TokenLoader(str(tmp_path), batch=4, seq=64, seed=1).batches(
        tokens.Cursor.from_dict(cursors[-1].to_dict())))
    np.testing.assert_array_equal(resumed["tokens"], b_next["tokens"])
