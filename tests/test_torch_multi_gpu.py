"""Data-parallel training of the port over torch.distributed, on the CPU:
gloo groups of two processes stand in for two cards, as
tests/test_multihost.py's two processes stand in for a pod.

- ``parallel.mesh``'s collectives in a two-process group.
- One ASE epoch on two ranks against one rank: the same tiny config
  (widths 32-16) at 32 envs (16 per rank), horizon 4, two minibatches per
  mini-epoch (so the global permutation matters) and unchunked resets,
  three envs ending their episodes in the epoch. The one-rank run's per-env
  draws (actions, latents, resets) are recorded and each rank is handed
  its rows of them through the ``_draw_*`` methods; the replicated draws
  (demo windows, buffer cursors, permutations, diversity latents, replay
  keeps) come from the shared seed on both sides. Tolerances as
  tests/test_multichip.py holds the reference's mesh to one device:
  metrics rtol 2e-3, atol 1e-4; weights within 5 lr (Adam turns a
  reduction-order difference in a near-zero gradient into a step of about
  lr, and the epoch takes four). The ranks must be bit-equal to each other.
- Checkpoints across world sizes: the two-rank run's file resumes strictly
  in a one-rank agent, and the one-rank run's in each rank.
- ``python -m ase_tpu_torch.run --multi_gpu --device cpu`` as two processes
  with torchrun's variables, for an AMP, an ASE and an HRL config.

The one-rank port is held to ``ase_tpu`` by tests/test_torch_train_epoch.py,
so the two-rank run is held to the reference through it.
"""

import copy
import multiprocessing
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from ase_tpu_torch import run
from ase_tpu_torch.envs import humanoid, parse_task
from ase_tpu_torch.learning.ase_agent import ASEAgent
from ase_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP = "data/motions/reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"
WORLD = 2
B = 32
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_vars(rank: int, port: int) -> dict:
    return {"RANK": str(rank), "WORLD_SIZE": str(WORLD), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def _join(rank: int, port: int):
    torch.set_num_threads(1)
    os.environ.update(_rank_vars(rank, port))
    return mesh_lib.init(backend="gloo", device="cpu")


def _spawn(target, *args):
    """Run ``target(rank, port, *args)`` in WORLD spawned processes; fail
    unless each exits 0 within TIMEOUT_S (a straggler is killed)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(rank, port) + args) for rank in range(WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD


# -- the collectives ------------------------------------------------------------------

def _collectives_rank(rank, port):
    mesh = _join(rank, port)
    try:
        assert (mesh.rank, mesh.world, mesh.staged) == (rank, WORLD, False)
        x = torch.arange(6.0).reshape(3, 2) + 10 * rank
        total = mesh.all_reduce_sum(x)
        assert torch.equal(total, 2 * torch.arange(6.0).reshape(3, 2) + 10)
        assert torch.equal(x, torch.arange(6.0).reshape(3, 2) + 10 * rank)   # not in place
        rows = mesh.all_gather_rows(x)
        assert torch.equal(rows, torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r
                                            for r in range(WORLD)]))
        ints = mesh.all_gather_rows(torch.tensor([[rank, 1 << 40]], dtype=torch.int64))
        assert ints.tolist() == [[r, 1 << 40] for r in range(WORLD)]
        assert torch.equal(mesh.broadcast(x, src=1), torch.arange(6.0).reshape(3, 2) + 10)
        seeds = mesh.all_gather_rows(torch.tensor([[mesh.rank_seed(7), mesh.replicated_seed(7)]]))
        assert len(set(seeds[:, 0].tolist())) == WORLD and len(set(seeds[:, 1].tolist())) == 1
    finally:
        mesh.close()


def test_mesh_collectives_in_a_two_process_gloo_group():
    """all_reduce_sum, all_gather_rows (rank order, int64 too) and
    broadcast, with known answers; per-rank seeds differ, the replicated
    one is shared."""
    _spawn(_collectives_rank)


def test_flags_check_what_the_group_can_split():
    """numEnvs and every minibatch row count must divide over the ranks
    (checked before any collective, so a bare Mesh of three ranks does)."""
    three = mesh_lib.Mesh(rank=0, world=3, device=torch.device("cpu"), staged=False)
    argv = ["--task", "HumanoidAMP", "--cfg_env", "humanoid_ase_sword_shield.yaml",
            "--cfg_train", "train/rlg/ase_humanoid.yaml", "--motion_file", CLIP,
            "--device", "cpu", "--multi_gpu"]
    with pytest.raises(ValueError, match="numEnvs 32 does not divide over 3 ranks"):
        run.build_agent(argv + ["--num_envs", "32"], mesh=three)
    # --test ignores the flags: a player builds without a group
    agent, _, _ = run.build_agent(argv + ["--num_envs", "2", "--test"])
    assert agent.mesh is None and agent.world == 1
    with pytest.raises(ValueError, match="minibatch rows 16384 do not split over 3 ranks"):
        ASEAgent(agent.env, agent.cfg_train, mesh=three)


# -- one ASE epoch: two ranks against one ---------------------------------------------

def _env_cfg(num_envs):
    with open(os.path.join(REPO, "data", "cfg", "humanoid_ase_sword_shield.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": num_envs, "resetChunk": 0, "motion_file": CLIP})
    cfg["task"] = {"randomize": False}
    cfg["seed"] = 5
    return cfg


def _ase_cfg(train_cfg):
    cfg = copy.deepcopy(train_cfg)
    cfg["params"]["algo"]["name"] = "ase"
    cfg["params"]["network"]["name"] = "ase"
    cfg["params"]["config"].update(minibatch_size=64, amp_minibatch_size=8)
    return cfg


def _agent(train_cfg, num_envs, mesh=None):
    """The contact solve in float32, as the port's parity tests run it: the
    CPU's bf16 Delassus product rounds differently at 16 and 32 envs, and
    stiff contacts grow that to 4.2 in two control steps."""
    env = parse_task("HumanoidAMP", _env_cfg(num_envs), device="cpu")
    env.sim_cfg = env.sim_cfg._replace(solver=env.sim_cfg.solver._replace(matvec_bf16=False))
    return ASEAgent(env, _ase_cfg(train_cfg), mesh=mesh)


def _snapshot(agent):
    return {"params": [p.detach().clone() for p in agent.network.parameters()],
            "normalizers": [t.clone() for t in agent._normalizer_tensors()],
            "roll": {k: v.clone() for k, v in agent.roll_state.items()},
            "checksum": agent.replica_checksum()}


def _replay(agent, draws, rows):
    """Hand ``agent`` its ``rows`` of the recorded per-env draws."""
    def fifo(queue):
        def draw(n):
            assert n == len(rows)
            return {k: v[rows] for k, v in queue.pop(0).items()}
        return draw

    agent._draw_actions = fifo(list(draws["actions"]))
    agent._draw_latents = fifo(list(draws["latents"]))
    agent.env._draw_reset = fifo(list(draws["reset"]))


def _epoch_rank(rank, port, out_dir, train_cfg):
    mesh = _join(rank, port)
    try:
        ref = torch.load(os.path.join(out_dir, "one_rank.pt"), weights_only=False)
        agent = _agent(train_cfg, B // WORLD, mesh)
        agent.setup_training()
        rows = torch.arange(rank * B // WORLD, (rank + 1) * B // WORLD)
        agent.roll_state = {k: v[rows] for k, v in ref["roll0"].items()}
        _replay(agent, ref["draws"], rows)
        _, record = agent.train_epoch(humanoid.take(ref["state0"], rows))
        out = {"record": record, "after": _snapshot(agent)}
        agent.save(os.path.join(out_dir, "two.ckpt"))
        agent.resume(os.path.join(out_dir, "one.ckpt.npz"))
        out["resumed"] = _snapshot(agent)
        out["resumed_epoch"] = agent.epoch
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def epochs(tmp_path_factory):
    """The one-rank epoch (its draws recorded, its checkpoint saved), then
    the two-rank epoch replaying them; returns (one-rank results, [rank 0,
    rank 1] results, directory, train config)."""
    from tests.test_learning import TRAIN_CFG

    out_dir = str(tmp_path_factory.mktemp("epochs"))
    agent = _agent(TRAIN_CFG, B)
    shared = torch.Generator().manual_seed(mesh_lib.Mesh.replicated_seed(
        int(agent.cfg_train["params"]["seed"]) + 1))
    agent.replicated_gen = agent.env.replicated_gen = shared
    state0 = agent.setup_training()
    # three envs, on both ranks, end their episodes at the first step
    progress = state0.progress.clone()
    progress[[0, 5, 20]] = agent.env.max_episode_length - 2
    state0 = state0.replace(progress=progress)
    roll0 = {k: v.clone() for k, v in agent.roll_state.items()}
    draws = {"actions": [], "latents": [], "reset": []}

    def record(obj, name, key):
        draw = getattr(obj, name)

        def recorded(n):
            d = draw(n)
            draws[key].append({k: v.clone() for k, v in d.items()})
            return d

        setattr(obj, name, recorded)

    record(agent, "_draw_actions", "actions")
    record(agent, "_draw_latents", "latents")
    record(agent.env, "_draw_reset", "reset")
    _, one_record = agent.train_epoch(copy.deepcopy(state0))
    torch.save({"state0": state0, "roll0": roll0, "draws": draws},
               os.path.join(out_dir, "one_rank.pt"))
    one = {"record": one_record, "after": _snapshot(agent)}
    agent.save(os.path.join(out_dir, "one.ckpt"))
    _spawn(_epoch_rank, out_dir, TRAIN_CFG)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return one, ranks, out_dir, TRAIN_CFG


def test_two_rank_epoch_matches_one_rank(epochs):
    one, ranks, _, train_cfg = epochs
    m1 = one["record"]["metrics"]
    assert m1["games_played"] == 3.0
    lr = float(train_cfg["params"]["config"]["learning_rate"])
    for r in ranks:
        m2 = r["record"]["metrics"]
        assert set(m2) == set(m1)
        for k in sorted(m1):
            np.testing.assert_allclose(m2[k], m1[k], rtol=2e-3, atol=1e-4, err_msg=k)
        assert r["record"]["env_steps_per_s"] > 0
        for a, b in zip(one["after"]["params"], r["after"]["params"]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=5 * lr)
        # the normalizers as the epoch test holds them to ase_tpu's: the
        # rollouts agree to ~1e-3 (float32 rounds per env at 16 and 32 envs)
        for a, b in zip(one["after"]["normalizers"], r["after"]["normalizers"]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=1e-4 * float(a.abs().max()))
    # the ranks are bit-equal replicas; each kept its own envs' latents
    a, b = (r["after"] for r in ranks)
    assert all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    assert all(torch.equal(x, y) for x, y in zip(a["normalizers"], b["normalizers"]))
    assert torch.equal(a["checksum"], b["checksum"])
    assert ranks[0]["record"]["metrics"] == ranks[1]["record"]["metrics"]
    latents = torch.cat([r["after"]["roll"]["ase_latents"] for r in ranks])
    np.testing.assert_allclose(latents.numpy(), one["after"]["roll"]["ase_latents"].numpy(),
                               rtol=0, atol=1e-6)


def test_two_rank_checkpoint_resumes_in_one_rank(epochs):
    """Rank 0 wrote the replicated train state with the per-env latents of
    all 32 envs; a one-rank agent restores it strictly."""
    _, ranks, out_dir, train_cfg = epochs
    path = os.path.join(out_dir, "two.ckpt.npz")
    saved = np.load(path)
    assert saved[".extra['ase_latents']"].shape == (B, 8) and int(saved[".epoch"]) == 1
    agent = _agent(train_cfg, B)
    agent.setup_training()
    agent.resume(path)
    after = ranks[0]["after"]
    assert agent.epoch == 1
    assert all(torch.equal(p, q) for p, q in zip(agent.network.parameters(), after["params"]))
    assert all(torch.equal(p, q) for p, q in zip(agent._normalizer_tensors(),
                                                 after["normalizers"]))
    for k in ("ase_latents", "latent_reset_steps"):
        assert torch.equal(agent.roll_state[k],
                           torch.cat([r["after"]["roll"][k] for r in ranks])), k


def test_one_rank_checkpoint_resumes_in_two_ranks(epochs):
    """The one-rank run's file, resumed on each rank: the same weights on
    both, and each rank's rows of the per-env latents."""
    one, ranks, _, _ = epochs
    for rank, r in enumerate(ranks):
        got = r["resumed"]
        assert r["resumed_epoch"] == 1
        assert all(torch.equal(p, q) for p, q in zip(got["params"], one["after"]["params"]))
        rows = slice(rank * B // WORLD, (rank + 1) * B // WORLD)
        assert torch.equal(got["roll"]["ase_latents"],
                           one["after"]["roll"]["ase_latents"][rows])


# -- the CLI under torchrun's variables ----------------------------------------------

def _tiny_cfg(train_cfg, algo, **config):
    cfg = copy.deepcopy(train_cfg)
    cfg["params"]["algo"]["name"] = algo
    cfg["params"]["network"]["name"] = algo
    cfg["params"]["config"].update(config)
    return cfg


def _llc(tmp_path, train_cfg):
    """(checkpoint, config) of a fresh tiny ASE low-level controller."""
    cfg = _ase_cfg(train_cfg)
    cfg["params"]["config"]["amp_obs_demo_buffer_size"] = 64
    path = tmp_path / "llc.yaml"
    path.write_text(yaml.safe_dump(cfg))
    env = parse_task("HumanoidAMP", _env_cfg(16), device="cpu")     # a batch of 64 rows
    agent = ASEAgent(env, cfg)
    agent.setup_training()
    return agent.save(str(tmp_path / "llc.ckpt")), str(path)


def _cli_argv(tmp_path, train_cfg, algo):
    if algo == "hrl":
        llc, llc_cfg = _llc(tmp_path, train_cfg)
        cfg = _tiny_cfg(train_cfg, "hrl", llc_config=llc_cfg, llc_steps=2, task_reward_w=0.9,
                        disc_reward_w=0.1, horizon_length=2, minibatch_size=4)
        task = ["--task", "HumanoidHeading", "--cfg_env", "humanoid_sword_shield_heading.yaml",
                "--llc_checkpoint", llc]
    else:
        # the adaptive lr (on the global KL) and gradient clipping run too
        cfg = _tiny_cfg(train_cfg, algo, lr_schedule="adaptive", truncate_grads=True)
        task = ["--task", "HumanoidAMP", "--cfg_env", "humanoid_ase_sword_shield.yaml"]
    if algo == "ase":
        # as the shipped configs: each process draws a seed; rank 0's must win
        cfg["params"]["seed"] = -1
    else:
        task += ["--seed", "3"]
    path = tmp_path / f"{algo}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return task + ["--cfg_train", str(path), "--motion_file", CLIP, "--num_envs", "8",
                   "--max_iterations", "2", "--device", "cpu",
                   "--output_path", str(tmp_path / "out"), "--multi_gpu"]


@pytest.mark.parametrize("algo", ["amp", "ase", "hrl"])
def test_cli_trains_on_two_processes(tmp_path, algo):
    """Two epochs of ``python -m ase_tpu_torch.run --multi_gpu --device cpu``
    in two processes: rank 0 alone prints the epoch lines and writes the
    checkpoint (with all 8 envs' rows), both print "training done"."""
    from tests.test_learning import TRAIN_CFG

    argv = _cli_argv(tmp_path, TRAIN_CFG, algo)
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = {**os.environ, **_rank_vars(rank, port), "HOME": str(tmp_path),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ase_tpu_torch.run"] + argv, cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(outs)
    path = tmp_path / "out" / "test.ckpt.npz"
    for rank, out in enumerate(outs):
        assert f"(rank {rank} of {WORLD}): 4 envs" in out and "training done" in out
        assert ("epoch 1 fps:" in out) == (rank == 0), out
        assert (f"saved {path}" in out) == (rank == 0), out
    saved = np.load(path)
    assert int(saved[".epoch"]) == 2
    if algo == "ase":
        assert saved[".extra['ase_latents']"].shape == (8, 8)
    assert saved[".extra['cur_rewards']"].shape == (8,)
