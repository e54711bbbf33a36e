"""Environment layer: batched humanoid tasks (port of ``ase_tpu/envs``).

The registry holds every task of the reference, under the reference's
names.
"""

from ase_tpu_torch.envs.humanoid import EnvState, Humanoid
from ase_tpu_torch.envs.humanoid_amp import HumanoidAMP
from ase_tpu_torch.envs.humanoid_amp_getup import HumanoidAMPGetup
from ase_tpu_torch.envs.humanoid_amp_task import HumanoidAMPTask
from ase_tpu_torch.envs.humanoid_heading import HumanoidHeading
from ase_tpu_torch.envs.humanoid_location import HumanoidLocation
from ase_tpu_torch.envs.humanoid_perturb import HumanoidPerturb
from ase_tpu_torch.envs.humanoid_reach import HumanoidReach
from ase_tpu_torch.envs.humanoid_strike import HumanoidStrike
from ase_tpu_torch.envs.humanoid_view_motion import HumanoidViewMotion

TASK_REGISTRY = {
    "Humanoid": Humanoid,
    "HumanoidAMP": HumanoidAMP,
    "HumanoidAMPGetup": HumanoidAMPGetup,
    "HumanoidHeading": HumanoidHeading,
    "HumanoidLocation": HumanoidLocation,
    "HumanoidReach": HumanoidReach,
    "HumanoidStrike": HumanoidStrike,
    "HumanoidPerturb": HumanoidPerturb,
    "HumanoidViewMotion": HumanoidViewMotion,
}


def parse_task(task_name: str, cfg, device="cuda"):
    """Instantiate a task by name."""
    try:
        cls = TASK_REGISTRY[task_name]
    except KeyError:
        raise ValueError(f"unknown task {task_name!r}; available: {sorted(TASK_REGISTRY)}")
    return cls(cfg, device=device)
