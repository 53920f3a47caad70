"""The port's mesh and multi-process scaffolding
(vqvae_tpu_torch/parallel/mesh.py, distributed.py, collectives.py)
against the JAX package's: mesh shapes, batch rows and parameter shard
shapes from a gloo world of 4 CPU ranks against JAX meshes over 4 of the
8 virtual CPU devices, ``local_batch_slice`` on a grid.  One world runs
every in-world check (tests/_torch_mesh_worker.py job ``mesh``)."""

import os

import jax
import numpy as np
import pytest

from _torch_mesh_worker import MESHES, mesh_key
from _torch_world import run_job
from vqvae_tpu.configs import get_config as jax_config
from vqvae_tpu.models import init_model as jax_init
from vqvae_tpu.models import init_vq_state as jax_vq_state
from vqvae_tpu.parallel import distributed as jdist
from vqvae_tpu.parallel.mesh import batch_sharding as jax_batch_sharding
from vqvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vqvae_tpu.parallel.mesh import param_shardings as jax_param_shardings
from vqvae_tpu_torch.configs import get_config
from vqvae_tpu_torch.convert import flatten
from vqvae_tpu_torch.parallel import distributed as dist_mod
from vqvae_tpu_torch.parallel.mesh import mesh_from_config


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_job(4, "mesh", tmp_path_factory.mktemp("mesh"))


def _jax_mesh(kw):
    return jax_make_mesh(devices=jax.devices()[:4], **kw)


@pytest.mark.parametrize("kw", MESHES, ids=mesh_key)
def test_mesh_shape_and_batch_rows_match_jax(ranks, kw):
    """Axes, their order and sizes as JAX's make_mesh gives them, and
    each rank's rows of a batch of 8 those of JAX's device at the same
    place of the mesh."""
    jm = _jax_mesh(kw)
    rows = jax_batch_sharding(jm).devices_indices_map((8,))
    for r, res in enumerate(ranks):
        got = res["meshes"][mesh_key(kw)]
        assert got["shape"] == dict(jm.shape)
        assert list(got["shape"]) == list(jm.axis_names)
        want = rows[jm.devices.flat[r]][0]
        assert got["rows"].indices(8) == want.indices(8)
        assert got["axes"] == (("slice", "data") if "slice" in jm.axis_names
                               else ("data",))
        shape = got["shape"]
        assert got["sizes"] == {
            "batch": shape.get("slice", 1) * shape["data"],
            "grad": shape.get("slice", 1) * shape["data"]
            * shape.get("seq", 1),
            "seq": shape.get("seq", 1), "model": shape["model"]}


def test_param_shardings_match_jax_shard_shapes(ranks):
    """model=2: each leaf's shard shape equals JAX's
    NamedSharding.shard_shape on the same tree, leaf by leaf, for the
    parameters and the EMA state."""
    jm = _jax_mesh({"model": 2})
    params = jax_init(jax.random.PRNGKey(0), jax_config("tiny").model)
    sh = flatten(jax.tree_util.tree_map(
        lambda s, x: np.zeros(s.shard_shape(x.shape)),
        jax_param_shardings(jm, params), params))
    want = {k: v.shape for k, v in sh.items()}
    vq = jax_vq_state(params)
    vsh = jax_param_shardings(jm, vq)
    want_vq = {"count": vsh.count.shard_shape(vq.count.shape),
               "sum": vsh.sum.shard_shape(vq.sum.shape)}
    full = flatten(jax.tree_util.tree_map(np.asarray, params))
    assert any(want[k] != full[k].shape for k in want)   # some are split
    for res in ranks:
        assert res["shards"] == want
        assert res["vq_shards"] == want_vq


def test_collectives_and_batch_placement(ranks):
    for r, res in enumerate(ranks):
        assert res["mean"] == [1.5] * 3
        # model pairs are neighbouring ranks (model innermost)
        pair = r - r % 2
        assert res["gather"] == [[pair, 10 * pair], [pair + 1,
                                                     10 * (pair + 1)]]
        sl = res["put_rows"]
        np.testing.assert_array_equal(
            res["put"], np.arange(40, dtype=np.float32).reshape(8, 5)[sl])


@pytest.mark.parametrize("B,n", [(32, 1), (32, 4), (8, 8), (12, 3),
                                 (30, 4), (7, 2)])
def test_local_batch_slice_matches_jax(B, n):
    for pi in range(n):
        if B % n:
            with pytest.raises(ValueError, match="not divisible"):
                dist_mod.local_batch_slice(B, pi, n)
            with pytest.raises(ValueError):
                jdist.local_batch_slice(B, pi, n)
            continue
        assert dist_mod.local_batch_slice(B, pi, n) == \
            jdist.local_batch_slice(B, pi, n)
    if B % n == 0:
        rows = [i for pi in range(n) for i in range(
            *dist_mod.local_batch_slice(B, pi, n).indices(B))]
        assert rows == list(range(B))


def test_single_process_defaults(monkeypatch):
    """Without torchrun's variables: no world, the whole batch, rank 0's
    device, and a mesh of one (None); a mesh larger than the world is
    refused, naming the setting and torchrun."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist_mod.initialize_from_env(device="cpu") is False
    assert dist_mod.local_batch_slice(16) == slice(0, 16)
    assert str(dist_mod.rank_device("cpu")) == "cpu"
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert str(dist_mod.rank_device("cuda:1")) == "cuda:1"
    tcfg = get_config("tiny").train
    assert mesh_from_config(tcfg, "cpu") is None
    import dataclasses
    with pytest.raises(ValueError, match="train.mesh_seq=2 .* torchrun "
                                         "--nproc-per-node 2"):
        mesh_from_config(dataclasses.replace(tcfg, mesh_seq=2), "cpu")
    assert os.environ.get("WORLD_SIZE") is None
