"""The port's LM models under a mesh, on gloo ranks on the CPU, against
the same step with no mesh; and the sharded checkpoints.

Two ranks (a 1 x 2 ``(data, model)`` mesh) and four (2 x 2) run
`torch_lm_shard_ranks.run`, spawned once per module with
`torch.multiprocessing` (a ``file://`` store under tmp, a 60 s collective
timeout, a join deadline): the ten REDUCED archs in f32, their weights
laid out per `param_specs`, the batch over the data axis (tokens;
musicgen's codes; llava's tokens and patch embeddings, which its training
step puts before the tokens), prefill, 3 greedy decode steps on the sharded
contiguous cache and
one `make_train_step` under `set_mesh_context`. Every rank's gathered
results are held against this process's one-rank run
(`torch_lm_shard_ranks.check_against_one_rank`):

  loss, prefill logits     within 1e-5 (logits: or within the one-rank f32
                           logits' own distance from an f64 run, where that
                           is larger: hymba's f32 prefill sits ~1.3e-5 from
                           its f64 one)
  decode steps             logits within 1e-4 (`test_torch_lm_serve.py`'s
                           bar), greedy tokens equal
  grad norm                within 1e-5 of its value, relative
  updated parameters       within 1e-5 wherever the one-rank gradient is at
                           least 1e-4 (AdamW's first step is g / (|g| + eps):
                           a gradient below its own rounding may flip sign),
                           and within 2 * lr everywhere

Then the checkpoints (`repro_torch.train.checkpoint`), in the same spawn:
both worlds save the state after one step sharded, the same arrays a
one-rank save of that state writes, which the reference's
`restore_checkpoint` reads bit for bit; the 2 x 2 checkpoint restores onto
1 x 2 and 2 x 1 (every leaf on its `state_shardings` layout, gathered bit
for bit the saved leaf) and with no mesh (`shardings=None`, as before);
one step after the restore onto 1 x 2 equals the uninterrupted 2 x 2
second step (loss 1e-5, grad norm 1e-5 relative, parameters within 2 lr
everywhere and within 1e-5 where the second step's first moment is at least
1e-3 of its leaf's largest: the clipped gradients are a grad norm smaller
than the raw ones); and a
checkpoint the reference wrote (bf16 weights) restores sharded bit for bit
and saves again, sharded, to the same arrays. Last, a tree that one rank
holds otherwise is refused by `distribute_tree` on every rank.
"""
import json
import os
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_lm_shard_ranks as ranks
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.train import checkpoint as tck

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 300
CKPT_CASES = [(a, w) for a in ranks.ARCHS for w in sorted(ranks.MESHES)]
# the second step's parameters are held within 1e-5 where the first moment is
# at least this share of its leaf's largest (`chip_smoke.py`'s TRAIN_SMALL_GRAD)
SIZEABLE_MOMENT = 1e-3


def _write_reference_checkpoints(out) -> None:
    """Each arch's `ref_state_arrays` written by the reference's
    `save_checkpoint` (its own TrainState, bf16 weights)."""
    for arch in ranks.ARCHS:
        arrays = ranks.ref_state_arrays(arch)
        leaves = {k: jnp.asarray(v.view(ml_dtypes.bfloat16) if k.startswith(".params") else v)
                  for k, v in arrays.items()}

        def tree(prefix):
            out = {}
            for k, v in leaves.items():
                if k.startswith(prefix):
                    node = out
                    parts = k[len(prefix):].split("/")
                    for p in parts[:-1]:
                        node = node.setdefault(p, {})
                    node[parts[-1]] = v
            return out

        state = jts.TrainState(tree(".params/"), jopt.AdamWState(
            leaves[".opt/.step"], tree(".opt/.m/"), tree(".opt/.v/")))
        jck.save_checkpoint(ranks.ref_ckpt_dir(str(out), arch), state, step=5)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_shard")
    _write_reference_checkpoints(out)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (SRC, os.environ.get("PYTHONPATH", "")) if p)
    ctxs = [mp.start_processes(ranks.run, args=(w, str(out / f"store{w}"), str(out)),
                               nprocs=w, join=False, start_method="spawn")
            for w in ranks.MESHES]
    deadline = time.monotonic() + DEADLINE_S
    procs = [p for c in ctxs for p in c.processes]
    try:
        for proc in procs:
            proc.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.pid for p in procs if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
    assert not hung, f"ranks {hung} still running after {DEADLINE_S} s"
    assert [p.exitcode for p in procs] == [0] * len(procs)
    return out


@pytest.fixture(scope="module")
def one_rank():
    return {a: ranks.compute(a) for a in ranks.ARCHS}


@pytest.mark.parametrize("world", sorted(ranks.MESHES))
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_step_matches_one_rank(spawned, one_rank, arch, world):
    logit_tol = max(ranks.TOL, ranks.f32_floor(arch))
    for rank in range(world):
        got = np.load(spawned / f"{arch}_w{world}_r{rank}.npz")
        ranks.check_against_one_rank(got, one_rank[arch], logit_tol, f"{arch} w{world} r{rank}")


@pytest.mark.parametrize("world", sorted(ranks.MESHES))
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_sharded_decode_matches_one_rank(spawned, one_rank, arch, world):
    """Prefill and 3 greedy steps on the sharded cache: tokens equal, every
    step's logits within 1e-4 (and as many steps as one rank ran)."""
    want = one_rank[arch]
    assert want["decode_logits"].shape[0] == ranks.DECODE_STEPS
    for rank in range(world):
        got = np.load(spawned / f"{arch}_w{world}_r{rank}.npz")
        np.testing.assert_array_equal(got["decode_tokens"], want["decode_tokens"])
        assert got["decode_logits"].shape == want["decode_logits"].shape
        gap = np.abs(got["decode_logits"] - want["decode_logits"]).max(axis=(1, 2))
        assert (gap <= ranks.DECODE_TOL).all(), (arch, world, rank, gap)


def _npz(path) -> dict:
    with np.load(os.path.join(path, "ckpt.npz")) as data:
        return {k: data[k] for k in data.files}


def _manifest(path) -> dict:
    with open(os.path.join(path, "manifest.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("arch,world", CKPT_CASES)
def test_sharded_save_equals_one_rank_save_and_reads_in_reference(spawned, arch, world):
    path = ranks.ckpt_dir(str(spawned), arch, world)
    sharded, plain = _npz(path), _npz(path + "_plain")
    assert sorted(os.listdir(path)) == ["ckpt.npz", "manifest.json"]
    assert _manifest(path) == _manifest(path + "_plain")
    assert sharded.keys() == plain.keys()
    for k, a in sharded.items():
        assert a.dtype == plain[k].dtype and np.array_equal(a, plain[k]), k
    like = ranks._meta_state(arch)
    restored, step = jck.restore_checkpoint(path, like)
    assert step == 1
    for (key, leaf), k in zip(jck._flatten(restored)[0], _manifest(path)["keys"]):
        assert key == k
        got = np.asarray(leaf)
        want = sharded[key.replace("/", "__")]
        assert got.dtype == want.dtype and np.array_equal(got, want), key


@pytest.mark.parametrize("mesh", ranks.RESTORE_MESHES)
@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_restore_onto_another_mesh_bit_for_bit(spawned, arch, mesh):
    saved = _npz(ranks.ckpt_dir(str(spawned), arch, ranks.CKPT_WORLD))
    prefix = f"restored_{mesh[0]}x{mesh[1]}/"
    for rank in range(2):
        got = np.load(spawned / f"ckpt_{arch}_w2_r{rank}.npz")
        assert int(got[prefix + "misplaced"]) == 0
        assert int(got[prefix + "sharded"]) > 0  # the layouts split some leaves
        assert int(got[prefix + "at"]) == 1
        keys = [k[len(prefix):] for k in got.files if k.startswith(prefix + ".")]
        assert sorted(k.replace("/", "__") for k in keys) == sorted(saved)
        for k in keys:
            want = saved[k.replace("/", "__")]
            assert got[prefix + k].dtype == want.dtype
            assert np.array_equal(got[prefix + k], want), (k, mesh, rank)


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_restore_with_no_mesh_unchanged(spawned, arch):
    path = ranks.ckpt_dir(str(spawned), arch, ranks.CKPT_WORLD)
    saved = _npz(path)
    restored, step = tck.restore_checkpoint(path, ranks._meta_state(arch), device="cpu")
    assert step == 1
    for key, leaf in tck._flatten(restored):
        assert type(leaf) is torch.Tensor and leaf.device.type == "cpu"
        assert np.array_equal(leaf.numpy(), saved[key.replace("/", "__")]), key


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_step_after_restore_equals_uninterrupted(spawned, arch):
    want = np.load(spawned / f"ckpt_{arch}_w{ranks.CKPT_WORLD}_r0.npz")
    lr = ranks.OPT["peak_lr"]
    for rank in range(2):
        got = np.load(spawned / f"ckpt_{arch}_w2_r{rank}.npz")
        prefix = "restored_1x2/step/"
        np.testing.assert_allclose(got[prefix + "loss"], want["next/loss"], rtol=0,
                                   atol=ranks.TOL)
        np.testing.assert_allclose(got[prefix + "grad_norm"], want["next/grad_norm"],
                                   rtol=ranks.TOL, atol=0)
        params = [k for k in want.files if k.startswith("next/param/")]
        assert params
        for k in params:
            name = k[len("next/param/"):]
            diff = np.abs(got[prefix + "param/" + name] - want[k])
            m = np.abs(want["next/m/" + name])  # the clipped gradients' running mean
            assert diff.max() <= 2 * lr * (1 + 1e-3), (name, float(diff.max()))
            sized = m >= SIZEABLE_MOMENT * m.max()
            assert diff[sized].max() <= ranks.TOL, (name, float(diff[sized].max()))


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_reference_checkpoint_restores_sharded(spawned, arch):
    path = ranks.ref_ckpt_dir(str(spawned), arch)
    written = _npz(path)
    assert _manifest(path)["bf16_keys"]  # the weights
    for rank in range(2):
        got = np.load(spawned / f"ckpt_{arch}_w2_r{rank}.npz")
        assert int(got["ref/misplaced"]) == 0 and int(got["ref/at"]) == 5
        for k, want in written.items():
            leaf = got["ref/" + k.replace("__", "/")]  # bf16 as its bit patterns
            assert leaf.dtype == want.dtype and np.array_equal(leaf, want), (k, rank)
    resaved = _npz(path + "_resaved")
    assert resaved.keys() == written.keys()
    for k, want in written.items():
        assert resaved[k].dtype == want.dtype and np.array_equal(resaved[k], want), k
    assert _manifest(path + "_resaved")["bf16_keys"] == _manifest(path)["bf16_keys"]


@pytest.mark.parametrize("world", sorted(ranks.MESHES))
def test_ranks_laying_out_different_trees_raise(spawned, world):
    """`distribute_tree` (and so `param_shardings`) refuses a tree that one
    rank holds otherwise, on every rank, naming the leaf."""
    for rank in range(world):
        msg = (spawned / f"disagree_w{world}_r{rank}.txt").read_text()
        assert "different values in 1 leaves, first ['b/c']" in msg, msg


def test_nccl_ranks_sharing_a_card_are_refused():
    from repro_torch.launch.mesh import _check_own_cards

    _check_own_cards(["host/GPU-a", "host/GPU-b", "other/GPU-a"])
    with pytest.raises(RuntimeError, match="ranks 0 and 2 are on one card"):
        _check_own_cards(["host/GPU-a", "host/GPU-b", "host/GPU-a"])


def test_card_ranks_without_cards_raise(tmp_path):
    """No quiet fallback: a rank of the card runs on a host without the
    cards it needs raises before it makes a process group."""
    if torch.cuda.device_count() >= 4:
        pytest.skip("this host has the cards")
    with pytest.raises(RuntimeError, match="needs card"):
        ranks.run_cards(3, 4, str(tmp_path / "store"), str(tmp_path), "nccl")


@pytest.mark.parametrize("arch", ranks.ARCHS)
def test_remat_backward_runs_under_the_forward_mesh(tmp_path, arch):
    """The backward of a sharded loss with remat, run on another thread (as
    on CUDA, whose autograd engine runs it on a device thread, which the
    ambient mesh does not reach), recomputes each block under the forward's
    mesh: the same gradients, DTensors over plain shards, as a backward on
    the calling thread."""
    import threading

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import lm_loss
    from repro_torch.sharding.rules import MeshAxes, set_mesh_context
    from repro_torch.train.optimizer import tree_leaves, tree_map

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        axes = MeshAxes()
        mesh = make_host_mesh(1, 1, device_type="cpu")
        cfg, params, batch = ranks._inputs(arch)
        params, batch = ranks._laid_out(params, batch, mesh, axes)
        grads = []
        for elsewhere in (False, True):
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            with set_mesh_context(mesh, axes):
                loss, _ = lm_loss(p, cfg, batch, remat=True)
                backward = lambda: grads.append(torch.autograd.grad(loss, tree_leaves(p)))  # noqa: E731
                if elsewhere:
                    thread = threading.Thread(target=backward)
                    thread.start()
                    thread.join()
                else:
                    backward()
        assert len(grads) == 2
        for a, b in zip(*grads):
            assert type(b.to_local()) is torch.Tensor
            assert torch.equal(a.to_local(), b.to_local())
    finally:
        dist.destroy_process_group()
