"""The port's ``parallel/mesh.py``, per-rank loading and the data-parallel
``Session`` on the CPU, held against the JAX package where it has the same
function.

* One process: ``make_mesh`` without a group is a one-rank mesh and
  ``setup_distributed`` starts nothing; ``local_batch_size``, the loader and
  ``Session.fit`` raise the JAX package's errors on a batch that does not
  divide; ``shard_batch`` gives each rank the rows the JAX package's
  ``shard_batch`` places on its device (flat and ``(2, 2)`` meshes); the
  port's ``DataLoader`` slices equal the JAX ``DataLoader``'s per
  ``process_index`` and together make the global batch; ``prefetch_to_mesh``
  copies a rank's slice and keeps ``meta``/``valid`` on the host.
* Four gloo ranks (``torch_ddp_worker.py``): a ``(2, 2)`` hierarchical mesh
  against the flat one, BatchNorm per replica (the counterpart of
  ``tests/test_multislice.py``), in float64: the JAX test's bounds, loss
  within 1e-5 relative, parameters within 2e-5.
* Two gloo ranks through the CLI (``cli.train.main``, the flagship with the
  trunk at ``reduced_depth()``, the bench loss stack, ``-b 2`` over a
  4+3-image roses fixture of 64x128, one epoch, the eval bucket at 72x136):
  rank 0 alone prints and writes the checkpoint, the replicas end equal, a
  one-process ``Session`` restores rank 0's state bit-equal, and the sharded
  eval (the second eval batch leaves rank 1 no real row) gives the rows and
  summary of the one-process eval CLI from that checkpoint, exactly.
"""
import os

import numpy as np
import pytest
import torch
from torch_port import numpy_batch, reduced_depth, spawn_ranks, torch_threads  # noqa: F401

from pmt_learning_for_semantic_segmentation_and_disparity_torch import data as TD
from pmt_learning_for_semantic_segmentation_and_disparity_torch.cli import train as cli
from pmt_learning_for_semantic_segmentation_and_disparity_torch.core import (
    PMTConfig,
    config_from_args,
)
from pmt_learning_for_semantic_segmentation_and_disparity_torch.parallel import mesh as tmesh
from pmt_learning_for_semantic_segmentation_and_disparity_torch.training import Session
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import data as JD
from pmt_learning_for_semantic_segmentation_and_disparity_tpu import parallel as jparallel
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.core import PMTConfig as JaxConfig
from pmt_learning_for_semantic_segmentation_and_disparity_tpu.training import Session as JaxSession

CPU = torch.device("cpu")
BUCKET = (72, 136)
FLAGS = ("-net sdnet_mini_ext -backbone densenet -corrType 1dcorr -crop 32 64 -b 2 -e 1 "
         "-loss cross_entropy lovasz_loss tversky_loss ohm_loss -output_activation linear "
         "-datasetName roses -show_results 0").split()


def _rank(shape, rank):
    """A rank's view of a mesh of ``shape`` without a process group: what
    every check made before a collective needs."""
    return tmesh.Mesh(dict(shape), rank, CPU)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    kw = dict(n_train=4, n_test=3, hw=(64, 128), seed=3)
    return root, TD.make_roses_fixture(str(root / "port"), **kw), JD.make_roses_fixture(
        str(root / "jax"), **kw)


def test_one_process_is_a_mesh_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "PMT_COORDINATOR", "PMT_NUM_PROCESSES", "PMT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.setup_distributed(device="cpu") is False
    mesh = tmesh.make_mesh(device="cpu")
    assert tuple(mesh.shape) == ("data",) and tmesh.mesh_size(mesh) == 1 and mesh.rank == 0
    assert mesh.data_group is None and mesh.replica_group is None
    batch = {"left": np.zeros((3, 2)), "valid": 3}
    assert tmesh.shard_batch(mesh, batch)["left"].shape == (3, 2)
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        tmesh.make_mesh(mesh_shape=(2, 2), device="cpu")


def test_batches_that_do_not_divide_raise_as_in_jax(manifests):
    _, port_m, jax_m = manifests
    jmesh = jparallel.make_mesh(n_devices=2)
    with pytest.raises(ValueError) as ref:
        jparallel.local_batch_size(3, jmesh)
    with pytest.raises(ValueError) as got:
        tmesh.local_batch_size(3, _rank({"data": 2}, 0))
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        JD.DataLoader([], 3, process_count=2)
    with pytest.raises(ValueError) as got:
        TD.DataLoader([], 3, process_count=2)
    assert str(got.value) == str(ref.value)
    errors = []
    for package, config, session, mesh, m in (
            (TD, PMTConfig, Session, dict(device=None, mesh=_rank({"data": 2}, 0)), port_m),
            (JD, JaxConfig, JaxSession, dict(mesh=jmesh), jax_m)):
        cfg = package.apply_fixture_to_config(config(), m)
        cfg.run.batch = 3
        with pytest.raises(ValueError) as e:
            session(cfg, **mesh).fit(log=lambda *a: None)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "-b 3 must be divisible" in errors[0]


@pytest.mark.parametrize("shape", [{"data": 4}, {"replica": 2, "data": 2}])
def test_shard_batch_gives_each_rank_its_jax_rows(shape):
    batch = {k: v for k, v in numpy_batch(0, (8, 8, 16)).items()}
    jmesh = (jparallel.make_mesh(n_devices=4) if len(shape) == 1
             else jparallel.make_mesh(mesh_shape=(2, 2)))
    placed = jparallel.shard_batch(jmesh, batch)
    devices = list(np.asarray(jmesh.devices).reshape(-1))  # replica-major, as the port's ranks
    for rank in range(4):
        got = tmesh.shard_batch(_rank(shape, rank), dict(batch, valid=7))
        assert got["valid"] == 7
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards if s.device == devices[rank])
            assert np.array_equal(got[k], np.asarray(shard.data)), (rank, k)


def test_loader_slices_match_jax(manifests):
    _, port_m, jax_m = manifests
    sets = {}
    for name, package, config, m in (("port", TD, PMTConfig, port_m), ("jax", JD, JaxConfig, jax_m)):
        cfg = package.apply_fixture_to_config(config(), m)
        norm = package.normalization_for(cfg.model.backbone, cfg.model.net)
        sets[name] = (package, package.build_datasets(cfg.data, "linear", 1.0, norm)[1])
    loader = dict(shuffle=True, seed=1, drop_last=False, bucket_hw=BUCKET, pad_batch=True)
    whole = list(TD.DataLoader(sets["port"][1], 2, **loader))
    assert [b["valid"] for b in whole] == [2, 1]
    for index in range(2):
        port, ref = (list(package.DataLoader(ds, 2, process_index=index, process_count=2, **loader))
                     for package, ds in sets.values())
        assert len(port) == len(ref) == len(whole)
        for a, b, w in zip(port, ref, whole):
            assert sorted(a) == sorted(b) and a["valid"] == b["valid"] == w["valid"]
            assert [os.path.basename(m[0]) for m in a["meta"]] == \
                   [os.path.basename(m[0]) for m in b["meta"]]
            for k in a:
                if k not in ("meta", "valid"):
                    assert a[k].shape[0] == 1 and np.array_equal(a[k], b[k]), k
                    assert np.array_equal(a[k], w[k][index:index + 1]), k


def test_prefetch_to_mesh_copies_the_rank_slice(manifests):
    _, port_m, _ = manifests
    cfg = TD.apply_fixture_to_config(PMTConfig(), port_m)
    norm = TD.normalization_for(cfg.model.backbone, cfg.model.net)
    testset = TD.build_datasets(cfg.data, "linear", 1.0, norm)[1]
    mesh = _rank({"data": 2}, 1)
    loader = TD.DataLoader(testset, 2, shuffle=False, drop_last=False, bucket_hw=BUCKET,
                           pad_batch=True, process_index=1, process_count=2)
    got = list(TD.prefetch_to_mesh(loader, mesh))
    assert [extras["valid"] for _, extras in got] == [2, 1]
    for (batch, extras), ref in zip(got, loader):
        assert isinstance(extras["meta"], list) and len(extras["meta"]) == 1
        for k, v in batch.items():
            assert v.device == CPU and torch.equal(v, torch.from_numpy(ref[k])), k
    with pytest.raises(ValueError, match="needs a loader of that rank's slice"):
        list(TD.prefetch_to_mesh(TD.DataLoader(testset, 2, drop_last=False), mesh))


@pytest.fixture(scope="module")
def hier_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier")
    np.savez(tmp / "batch.npz", **numpy_batch(1, (4, 64, 128)))
    return spawn_ranks(4, tmp, task="hier", mesh_shape=[2, 2], batch=str(tmp / "batch.npz"))


def test_hierarchical_mesh_equals_flat(hier_ranks):
    ranks = hier_ranks
    for r in ranks:
        assert r["hier_shape"] == {"replica": 2, "data": 2}
        (flat, flat_params, _, _), (hier, hier_params, _, _) = r["flat"], r["hier"]
        np.testing.assert_allclose(float(hier["loss"]), float(flat["loss"]), rtol=1e-5)
        for k in ("conf1", "conf2", "disp_err3px", "disp_valid"):
            assert np.array_equal(hier[k], flat[k]), k
        for n, v in flat_params.items():
            np.testing.assert_allclose(hier_params[n], v, rtol=0, atol=2e-5, err_msg=n)
        for n, v in ranks[0]["hier"][1].items():  # every replica applied one update
            assert np.array_equal(r["hier"][1][n], v), n


@pytest.fixture(scope="module")
def cli_ranks(manifests):
    root, port_m, _ = manifests
    flags = {"-colorL": "left", "-colorR": "right", "-seg": "seg", "-disp": "disp", "-inst": "inst"}
    data = [a for flag, k in flags.items() for a in (flag, port_m[k], flag + "_test", port_m[k + "_t"])]
    argv = data + FLAGS + ["-w_savePath", str(root / "runs")]
    ranks = spawn_ranks(2, root, task="cli", argv=argv, bucket=list(BUCKET))
    ckpt = os.path.join(str(root / "runs"), config_from_args(argv).model_id())
    return {"ranks": ranks, "argv": argv, "data": data, "ckpt": ckpt}


def _small(argv):
    cfg = config_from_args(argv)
    cfg.data.eval_shape = BUCKET
    cfg.data.num_workers = 2
    return cfg


def test_cli_two_ranks_rank0_alone_logs_and_writes(cli_ranks):
    zero, one = cli_ranks["ranks"]
    assert zero["saves"] == 1 and one["saves"] == 0
    assert "model id:" in zero["printed"] and "final eval:" in zero["printed"]
    assert one["printed"] == ""
    files = sorted(os.listdir(cli_ranks["ckpt"]))
    assert "meta_0.json" in files and "best.json" in files
    assert len([f for f in files if f.startswith("model_best_IOU")]) == 1
    assert len(zero["timings"]["step_s"]) == len(one["timings"]["step_s"]) == 2
    assert set(zero["state"]) == set(one["state"])
    for k, v in zero["state"].items():
        assert torch.equal(v, one["state"][k]), k
    assert zero["rows"] == one["rows"] and len(zero["rows"]) == 3


def test_cli_checkpoint_restores_bit_equal(cli_ranks):
    with reduced_depth():
        session = Session(_small(cli_ranks["argv"]), device="cpu")
        session.init_state(steps_per_epoch=2)
        assert session.restore(cli_ranks["ckpt"])[0] == 1
    state = session.model.state_dict()
    for k, v in cli_ranks["ranks"][0]["state"].items():
        assert torch.equal(state[k], v), k


def test_cli_sharded_eval_equals_one_process_eval(cli_ranks):
    argv = cli_ranks["data"] + FLAGS + ["-train", "0", "-load_weights", cli_ranks["ckpt"]]
    with reduced_depth(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "config_from_args", _small)
        session = cli.main(argv, device="cpu")
    zero = cli_ranks["ranks"][0]
    assert len(session.accumulator.rows) == 3
    for got, ref in zip(zero["rows"], session.accumulator.rows):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert np.array_equal(got[k], v), k
    assert zero["summary"] == session.eval_summary
