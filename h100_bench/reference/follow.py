"""The plain reference's side of the comparison.

The reference is ``reference/ase_ref``: a frozen copy of the port's plain
code paths (engine, env, motion library, networks, agents, players) that
imports nothing of ``ase_tpu_torch`` and launches no hand-written kernel
(its Cholesky is the plain tensor-op version). It builds its own model
from the asset file, its own motion library from the clips, its own
networks (from the same seed, or from the checkpoint file) and its own
normalizers and buffers.

Physics is chaotic, so the reference follows the program step by step
from the program's own state: at each checked point it takes the state the
program had before the step (and the program's fall-state table, which the
program's set-up dropped), is handed the same random streams, runs the
step itself and returns what it produced. The start (the initial reset of
every env) is checked by itself from the same streams.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List

import torch

from h100_bench.reference.ase_ref.envs import humanoid as r_humanoid
from h100_bench.reference.ase_ref.envs.humanoid_amp_getup import HumanoidAMPGetup
from h100_bench.reference.ase_ref.envs.humanoid_heading import HumanoidHeading
from h100_bench.reference.ase_ref.learning import players as r_players
from h100_bench.reference.ase_ref.learning.ase_agent import ASEAgent
from h100_bench.reference.ase_ref.learning.hrl_agent import HRLAgent
from h100_bench.reference.ase_ref.ops import chol as r_chol
from h100_bench.reference.ase_ref.physics import dynamics as r_dynamics

TASKS = {"HumanoidAMPGetup": HumanoidAMPGetup, "HumanoidHeading": HumanoidHeading}
AGENTS = {"ase": ASEAgent, "hrl": HRLAgent}
PLAYERS = {"ase": r_players.ASEPlayer, "hrl": r_players.HRLPlayer}


def to_ref(x, device):
    """A program state as the reference's classes, its tensors copied to
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, dict):
        return {k: to_ref(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and type(x).__name__ == "EnvState":
        return r_humanoid.EnvState(**{f.name: to_ref(getattr(x, f.name), device)
                                      for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and type(x).__name__ == "State":
        return r_dynamics.State(*(to_ref(v, device) for v in x))
    raise TypeError(f"no reference form for {type(x).__name__}")


class Reference:
    """The reference's env and agent (and player), built from the same
    configuration dicts the program ran."""

    def __init__(self, cfg: Dict[str, Any], cfg_train: Dict[str, Any], task: str,
                 device: torch.device, checkpoint: str = None):
        import copy

        self.device = device
        self.env = TASKS[task](copy.deepcopy(cfg), device=device)
        algo = cfg_train["params"]["algo"]["name"]
        self.agent = AGENTS[algo](self.env, copy.deepcopy(cfg_train), output_dir="unused")
        self.player = None
        if checkpoint is not None:
            self.player = PLAYERS[algo](self.agent)
            self.player.restore(checkpoint)

    def set_gens(self, gens: Dict[str, torch.Tensor]) -> None:
        self.env.gen.set_state(gens["env"])
        self.agent.gen.set_state(gens["agent"])

    # -- the start -----------------------------------------------------------------

    def start(self, fall_states, gens) -> Any:
        """The initial reset of every env, from the program's fall-state
        table (if the task has one) and the given streams."""
        if fall_states is not None:
            self.env._fall_states = to_ref(fall_states, self.device)
        self.set_gens(gens)
        return self.env.initial_state()

    # -- a player step --------------------------------------------------------------

    @torch.no_grad()
    def play_step(self, state, roll, gens):
        """One ``_policy_step`` from the program's state: (the state after
        its first control step, rewards, actions)."""
        self.set_gens(gens)
        first = []
        step = self.env.step

        def first_step(s, a):
            out = step(s, a)
            if not first:
                first.append(out)
            return out

        self.env.step = first_step
        try:
            _, _, rewards, actions = self.player._policy_step(to_ref(state, self.device),
                                                              to_ref(roll, self.device))
        finally:
            del self.env.step
        return first[0], rewards, actions

    # -- a rollout step ----------------------------------------------------------------

    @torch.no_grad()
    def rollout_step(self, state, roll, gens):
        """One iteration of the agent's rollout loop from the program's
        state: (state, roll, the step's record, actions)."""
        a = self.agent
        self.set_gens(gens)
        env_state, roll = to_ref(state, self.device), to_ref(roll, self.device)
        B = a.num_actors
        env_state = a.env.reset_done(env_state)
        env_state, roll = a._pre_rollout_step(env_state, roll)
        obs = env_state.obs
        obs_n = a.obs_rms.normalize(obs) if a.normalize_input else obs
        d = a._draw_actions(B)
        mu, log_sigma = a._actor_sigma(obs_n, roll)
        value = a._denorm_value(a._critic(obs_n, roll))
        sampled = mu + torch.exp(log_sigma) * d["noise"]
        rand_mask = a._rand_action_mask(d["u_mask"])
        actions = torch.where(rand_mask[:, None] > 0, sampled, mu)
        neglogp = a._neglogp(actions, mu, log_sigma)
        env_state, rewards, infos = a._env_step(env_state, actions)
        dones = env_state.reset_buf.to(torch.float32)
        terminated = env_state.terminate_buf.to(torch.float32)
        next_obs_n = a.obs_rms.normalize(env_state.obs) if a.normalize_input else env_state.obs
        next_value = a._denorm_value(a._critic(next_obs_n, roll)) * (1.0 - terminated[:, None])
        rec = {"obs": obs, "actions": actions, "mu": mu, "sigma": log_sigma,
               "neglogp": neglogp, "values": value, "rewards": rewards[:, None],
               "dones": dones, "next_values": next_value, "rand_action_mask": rand_mask}
        rec = a._record_step(env_state, roll, rec, infos)
        return env_state, roll, rec, actions

    # -- the update ----------------------------------------------------------------

    def train_update(self, recs: List[Dict[str, torch.Tensor]], roll, post_gens,
                     minibatches: int) -> Dict[str, Any]:
        """The rest of the rollout phase on the reference's own records
        (game meters, style and encoder rewards, GAE, the dataset), then the
        update's first ``minibatches`` optimizer steps. Returns the losses,
        the first gradient (from Adam's state after one step) and the
        weights before and after."""
        a = self.agent
        with torch.no_grad():
            self.set_gens(post_gens)
            batch = {k: torch.stack([r[k] for r in recs]) for k in recs[0]}
            a._post_rollout(roll)
            for t in range(a.horizon_length):
                a._update_game_meters(batch["rewards"][t, :, 0], batch["dones"][t],
                                      batch["successes"][t] if "successes" in batch else None)
            batch = a._process_rewards(batch)
            batch["returns"] = a._discount_values(
                batch["dones"], batch["values"], batch["rewards"],
                batch["next_values"]) + batch["values"]
            dataset = a._prepare_dataset(batch)
        p0 = {n: p.detach().clone() for n, p in a.network.named_parameters()}
        perm = a._draw_minibatch_perm()
        losses, g1 = [], None
        for i in range(minibatches):
            idx = perm[i * a.minibatch_size:(i + 1) * a.minibatch_size]
            metrics = a._update_minibatch(a._gather_minibatch(dataset, idx))
            losses.append(float(metrics["loss"]))
            if i == 0:
                beta1 = a.optimizer.param_groups[0]["betas"][0]
                g1 = {n: a.optimizer.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                      for n, p in a.network.named_parameters() if p in a.optimizer.state}
        p3 = {n: p.detach().clone() for n, p in a.network.named_parameters()}
        return {"loss": losses, "g1": g1, "p0": p0, "p3": p3}

    def init_train_state(self, gens) -> None:
        self.set_gens(gens)
        self.agent.init_train_state()


@contextlib.contextmanager
def float64_cholesky():
    """The reference's engine with its Cholesky factor and both
    substitutions in float64 (inputs and results float32, as the engine
    holds them; the factor stays float64 between the two calls)."""
    saved = r_chol.chol_forward, r_chol.back_solve
    factors = {}

    def forward(M, rhs, rhs2=None):
        out = r_chol.chol_forward_plain(M.double(), rhs.double(),
                                        None if rhs2 is None else rhs2.double())
        L = out[0].float()
        factors[id(L)] = (L, out[0])
        return (L,) + tuple(t.float() for t in out[1:])

    def back(L, y):
        L64 = factors[id(L)][1] if id(L) in factors else L.double()
        return r_chol.back_solve_plain(L64, y.double()).float()

    r_chol.chol_forward, r_chol.back_solve = forward, back
    try:
        yield
    finally:
        r_chol.chol_forward, r_chol.back_solve = saved


def leaf_norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                  keep=None) -> Dict[str, float]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; ``keep`` names the leaves counted."""
    names = [n for n in ref if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) if n in prog else 0.0
          for n in names}
    med = sorted(rn.values())[len(rn) // 2] if rn else 0.0
    worst, leaf = 0.0, None
    for n in names:
        g = abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
        if g > worst or leaf is None:
            worst, leaf = g, n
    return {"gap": worst, "leaf": leaf, "median_norm": med}


def moved_leaves(g1_ref: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {n: float(torch.linalg.vector_norm(v.double())) for n, v in g1_ref.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= 1e-3 * med]
