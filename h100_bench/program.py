"""Driving the program, ``ase_tpu_torch``, through its CLI layer's entry
points (``run.build_agent`` and ``run.build_player``), from a cell's files.

One general runner serves every cell: the configuration file gives the
task, the shipped yamls (laid over by the file's own copies), the motion
file and the checkpoints; the traffic file gives the mode (``train`` or
``play``), the envs, the episode-clock rule, the warm-up and the window.
Set-up builds the objects, times its stages after a sync, snapshots what
the reference follows (``Capture``), and warms up; the window then drives
the same objects.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import torch

from h100_bench import cells
from h100_bench.tracing.spans import Patches

PROGRAM_SEED_MOD = 2 ** 31 - 1


def program_seed(seed: int) -> int:
    """The program's seed for the benchmark's ``--seed`` (any whole number):
    numpy and the yamls take seeds below 2**31."""
    return int(seed) % PROGRAM_SEED_MOD


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snap(x):
    """A deep copy of a state: tensors cloned, containers rebuilt."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: snap(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: snap(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snap(v) for v in x))
    return x


def to_host(x):
    """``snap`` to host memory (the set-up epoch's captured states leave the
    card before the window, so its memory peak is the program's)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    if isinstance(x, SimpleNamespace):
        return SimpleNamespace(**{k: to_host(v) for k, v in vars(x).items()})
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    return x


def outcome(state) -> SimpleNamespace:
    """What a step's comparison reads of its output state."""
    return SimpleNamespace(obs=snap(state.obs), reset_buf=snap(state.reset_buf))


def first_step_outcome(patches: Patches, env) -> SimpleNamespace:
    """A namespace that the first ``env.step`` call after this fills with
    its ``outcome`` (an HRL player step runs several control steps; the
    comparison reads the first)."""
    out = SimpleNamespace()

    def make(fn):
        def wrapper(state, actions):
            new = fn(state, actions)
            if not vars(out):
                out.__dict__.update(vars(outcome(new)))
            return new
        return wrapper

    patches.wrap(env, "step", make)
    return out


def gen_states(env, agent) -> Dict[str, torch.Tensor]:
    """The random streams both sides draw from, as (seed, offset) states."""
    return {"env": env.gen.get_state(), "agent": agent.gen.get_state()}


# -- building -------------------------------------------------------------------


def _repo_path(rel: str) -> str:
    return rel if os.path.isabs(rel) else os.path.join(cells.ROOT, rel)


def argv(conf: Dict[str, Any], traffic: Dict[str, Any], seed: int, device: str,
         output_dir: str) -> List[str]:
    a = ["--task", conf["task"], "--cfg_env", conf["cfg_env"], "--cfg_train", conf["cfg_train"],
         "--motion_file", conf["motion_file"], "--num_envs", str(traffic["envs"]),
         "--seed", str(program_seed(seed)), "--device", device, "--output_path", output_dir]
    if traffic["mode"] == "play":
        a += ["--test", "--checkpoint", _repo_path(conf["checkpoint"])]
    if conf.get("llc_checkpoint"):
        a += ["--llc_checkpoint", _repo_path(conf["llc_checkpoint"])]
    return a


def edit_cfg_fn(conf: Dict[str, Any], overrides: Optional[Dict[str, Any]]):
    """Lay the configuration file's copies of the yamls (then a test's
    ``overrides``) over the loaded ones, keeping what the command line set."""
    def edit(cfg, cfg_train):
        kept_env = {k: cfg["env"][k] for k in ("numEnvs", "motion_file") if k in cfg["env"]}
        kept_top = {k: cfg[k] for k in ("seed", "name", "headless", "task") if k in cfg}
        tc = cfg_train["params"]["config"]
        kept_train = {k: tc[k] for k in ("num_actors", "llc_checkpoint", "name") if k in tc}
        seed = cfg_train["params"]["seed"]
        new_env = cells.merged(cfg, conf["env_cfg"])
        new_train = cells.merged(cfg_train, conf["train_cfg"])
        new_env["env"].update(kept_env)
        new_env.update(kept_top)
        new_train["params"]["config"].update(kept_train)
        new_train["params"]["seed"] = seed
        if overrides:
            new_env = cells.merged(new_env, overrides.get("env_cfg", {}))
            new_train = cells.merged(new_train, overrides.get("train_cfg", {}))
        cfg.clear()
        cfg.update(new_env)
        cfg_train.clear()
        cfg_train.update(new_train)
    return edit


@dataclasses.dataclass
class Built:
    agent: Any
    env: Any
    player: Any
    cfg: Dict[str, Any]
    cfg_train: Dict[str, Any]
    device: torch.device


def build(conf, traffic, seed: int, device: str = "cuda", overrides=None) -> Built:
    import copy

    from ase_tpu_torch import run as prun

    out = os.path.join(tempfile.gettempdir(), "h100_bench_output")
    a = argv(conf, traffic, seed, device, out)
    edit = edit_cfg_fn(conf, overrides)
    if traffic["mode"] == "play":
        player, cfg = prun.build_player(a, edit_cfg=edit)
        player.print_stats = False
        agent = player.agent
    else:
        agent, _, cfg = prun.build_agent(a, edit_cfg=edit)
        player = None
    return Built(agent=agent, env=agent.env, player=player, cfg=copy.deepcopy(cfg),
                 cfg_train=copy.deepcopy(agent.cfg_train), device=agent.device)


def stagger_clocks(env, state, seed: int):
    """Each env's episode clock as a seeded uniform draw in [0,
    episodeLength): the harness's own draw, from its own generator."""
    g = torch.Generator(device=state.progress.device)
    g.manual_seed(int(seed) % (2 ** 63 - 1))
    progress = torch.randint(0, env.max_episode_length, state.progress.shape, generator=g,
                             device=state.progress.device, dtype=state.progress.dtype)
    return state.replace(progress=progress)


# -- what the reference follows ----------------------------------------------------


@dataclasses.dataclass
class Capture:
    """What the program produced at the checked points, and the inputs it
    had there: the states before and after, the random streams' states."""
    fall_states: Any = None
    start_gens: Dict[str, torch.Tensor] = None
    start_state: Any = None            # after the initial reset, before the clock rule
    demo_gens: Dict[str, torch.Tensor] = None
    steps: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    post_rollout_gens: Dict[str, torch.Tensor] = None
    update: Dict[str, Any] = dataclasses.field(default_factory=dict)


def capture_epoch(patches: Patches, agent, cap: Capture, minibatches: int) -> None:
    """Hooks for one training epoch: every rollout step's input state, roll
    and random streams, its actions and output state; the streams after the
    rollout; the update's first ``minibatches`` losses, the first gradient
    as Adam holds it after one step, and the weights before and after."""
    env = agent.env

    def on_reset_done(fn):
        def wrapper(state):
            cap.steps.append({"state": snap(state), "gens": gen_states(env, agent)})
            return fn(state)
        return wrapper

    def on_pre_rollout(fn):
        def wrapper(state, roll):
            step = cap.steps[-1]
            if "roll" not in step:
                step["roll"] = snap(roll)
            return fn(state, roll)
        return wrapper

    def on_env_step(fn):
        def wrapper(state, actions):
            out = fn(state, actions)
            cap.steps[-1]["actions"] = snap(actions)
            cap.steps[-1]["out"] = outcome(out[0])
            return out
        return wrapper

    def on_post_rollout(fn):
        def wrapper(roll):
            cap.post_rollout_gens = gen_states(env, agent)
            return fn(roll)
        return wrapper

    def on_minibatch(fn):
        def wrapper(mb):
            k = cap.update.setdefault("calls", 0)
            if k == 0:
                cap.update["p0"] = {n: snap(p) for n, p in agent.network.named_parameters()}
                cap.update["gens"] = gen_states(env, agent)
            metrics = fn(mb)
            if k < minibatches:
                cap.update.setdefault("loss", []).append(float(metrics["loss"]))
            if k == 0:
                beta1 = agent.optimizer.param_groups[0]["betas"][0]
                cap.update["g1"] = {n: agent.optimizer.state[p]["exp_avg"].detach() / (1 - beta1)
                                    for n, p in agent.network.named_parameters()
                                    if p in agent.optimizer.state}
                cap.update["g1"] = {n: v.clone() for n, v in cap.update["g1"].items()}
            if k == minibatches - 1:
                cap.update["p3"] = {n: snap(p) for n, p in agent.network.named_parameters()}
            cap.update["calls"] = k + 1
            return metrics
        return wrapper

    patches.wrap(env, "reset_done", on_reset_done)
    patches.wrap(agent, "_pre_rollout_step", on_pre_rollout)
    patches.wrap(agent, "_env_step", on_env_step)
    patches.wrap(agent, "_post_rollout", on_post_rollout)
    patches.wrap(agent, "_update_minibatch", on_minibatch)


# -- counters --------------------------------------------------------------------


def count_resets(patches: Patches, env) -> Dict[str, List[int]]:
    """Per ``reset_done`` call: the passes that reset at least one env, and
    the envs they reset (read from the pass's own return, no sync)."""
    rec = {"passes": [], "flagged": []}

    def on_reset_done(fn):
        def wrapper(state):
            rec["passes"].append(0)
            rec["flagged"].append(0)
            return fn(state)
        return wrapper

    def on_pass(fn):
        def wrapper(state, chunk):
            state, n = fn(state, chunk)
            if rec["passes"]:
                rec["passes"][-1] += int(n > 0)
                rec["flagged"][-1] += int(n)
            return state, n
        return wrapper

    patches.wrap(env, "reset_done", on_reset_done)
    patches.wrap(env, "_reset_chunk_pass", on_pass)
    return rec


def record_chol_calls(patches: Patches) -> List[tuple]:
    """The shapes of the engine's Cholesky calls: ("chol_forward2" or
    "back_solve", n, m, m2, B)."""
    from ase_tpu_torch.ops import chol

    calls: List[tuple] = []

    def on_forward(fn):
        def wrapper(M, rhs, rhs2=None):
            n, B = M.shape[0], M.shape[2]
            if rhs2 is None:
                calls.append(("chol_forward", n, rhs.shape[1], 0, B))
            else:
                calls.append(("chol_forward2", n, rhs.shape[1], rhs2.shape[1], B))
            return fn(M, rhs, rhs2)
        return wrapper

    def on_back(fn):
        def wrapper(L, y):
            calls.append(("back_solve", L.shape[0], y.shape[1], 0, L.shape[2]))
            return fn(L, y)
        return wrapper

    patches.wrap(chol, "chol_forward", on_forward)
    patches.wrap(chol, "back_solve", on_back)
    return calls


# -- windows ------------------------------------------------------------------------


class StepEvents:
    """CUDA events at each player step's boundary (traced runs), read after
    the window."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.events: List[torch.cuda.Event] = []

    def mark(self) -> None:
        if self.on:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in zip(self.events[:-1], self.events[1:])]


def play_window(player, state, roll, seconds: float, chunk: int, device,
                on_step: Optional[Callable] = None, events: Optional[StepEvents] = None):
    """Drive ``player._policy_step`` in chunks of ``chunk`` steps, reading
    the done tallies once a chunk as ``CommonPlayer.run`` does, until
    ``seconds`` have passed; the window ends in a sync. Returns (state,
    roll, steps, games, wall seconds)."""
    B = player.env.num_envs
    ret = torch.zeros(B, device=device)
    steps, games = 0, 0
    sync(device)
    t0 = time.perf_counter()
    if events is not None:
        events.mark()
    over = False
    while not over:
        tallies = []
        for _ in range(chunk):
            if on_step is not None:
                on_step("pre", steps, state, roll)
            state, roll, rewards, actions = player._policy_step(state, roll)
            if on_step is not None:
                on_step("post", steps, state, roll, rewards, actions)
            if events is not None:
                events.mark()
            ret = ret + rewards
            done = state.reset_buf > 0
            tallies.append(torch.stack([done.sum().to(torch.float32),
                                        torch.where(done, ret, torch.zeros_like(ret)).sum()]))
            ret = torch.where(done, torch.zeros_like(ret), ret)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                over = True
                break
        games += int(sum(c for c, _ in torch.stack(tallies).cpu().tolist()))
    sync(device)
    return state, roll, steps, games, time.perf_counter() - t0


def train_window(agent, state, seconds: float, device):
    """Whole epochs of ``agent.train_epoch``; an epoch starts only while it
    should end inside ``seconds`` (judged by the last epoch's wall). The
    window ends in a sync (``seconds`` 0: no epoch, for readings of the
    comparison alone). Returns (state, epoch records, wall seconds)."""
    records = []
    sync(device)
    t0 = time.perf_counter()
    while seconds > 0:
        state, rec = agent.train_epoch(state)
        records.append(rec)
        if time.perf_counter() - t0 + rec["wall_s"] > seconds:
            break
    sync(device)
    return state, records, time.perf_counter() - t0


def llc_steps(agent) -> int:
    """Control steps per player step: an HRL decision runs ``llc_steps``."""
    return int(getattr(agent, "_llc_steps", 1))
