"""Observation / termination functions on batched tensors (port of
``ase_tpu/envs/obs.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from h100_bench.reference.ase_ref.ops import quat as rot


def dof_to_obs(pose: torch.Tensor, dof_offsets: Sequence[int]) -> torch.Tensor:
    """Per-joint 6D tangent-normal encoding of dof positions: (B, D) ->
    (B, 6 * num_joints)."""
    y_axis = torch.tensor([0.0, 1.0, 0.0], device=pose.device)
    pieces = []
    for j in range(len(dof_offsets) - 1):
        off = dof_offsets[j]
        size = dof_offsets[j + 1] - off
        joint_pose = pose[..., off:off + size]
        if size == 3:
            q = rot.exp_map_to_quat(joint_pose)
        elif size == 1:
            q = rot.quat_from_angle_axis(joint_pose[..., 0], y_axis)
        else:
            raise ValueError("unsupported joint size")
        pieces.append(rot.quat_to_tan_norm(q))
    return torch.cat(pieces, dim=-1)


def compute_humanoid_observations_max(body_pos, body_rot, body_vel, body_ang_vel,
                                      local_root_obs: bool, root_height_obs: bool):
    """Full-body 'max' observation (1 + nb*15 - 3 dims)."""
    B = body_pos.shape[0]
    root_pos = body_pos[:, 0, :]
    root_rot = body_rot[:, 0, :]
    root_h = root_pos[:, 2:3]
    heading_rot = rot.calc_heading_quat_inv(root_rot)
    root_h_obs = root_h if root_height_obs else torch.zeros_like(root_h)
    hr = heading_rot[:, None, :]

    local_body_pos = rot.quat_rotate(hr, body_pos - root_pos[:, None, :])
    local_body_pos = local_body_pos.reshape(B, -1)[..., 3:]

    local_body_rot = rot.quat_mul(hr.expand(body_rot.shape), body_rot)
    local_body_rot_obs = rot.quat_to_tan_norm(local_body_rot)
    if local_root_obs:
        local_body_rot_obs = local_body_rot_obs.clone()
        local_body_rot_obs[:, 0, :] = rot.quat_to_tan_norm(root_rot)
    local_body_rot_obs = local_body_rot_obs.reshape(B, -1)

    local_body_vel = rot.quat_rotate(hr, body_vel).reshape(B, -1)
    local_body_ang_vel = rot.quat_rotate(hr, body_ang_vel).reshape(B, -1)
    return torch.cat([root_h_obs, local_body_pos, local_body_rot_obs,
                      local_body_vel, local_body_ang_vel], dim=-1)


def compute_humanoid_observations(root_pos, root_rot, root_vel, root_ang_vel, dof_pos,
                                  dof_vel, key_body_pos, local_root_obs: bool,
                                  root_height_obs: bool, dof_offsets):
    """The reduced observation (the reference's ``obs.py:83``): the AMP
    layout of ``build_amp_observations``."""
    return build_amp_observations(root_pos, root_rot, root_vel, root_ang_vel, dof_pos,
                                  dof_vel, key_body_pos, local_root_obs, root_height_obs,
                                  dof_offsets)


def build_amp_observations(root_pos, root_rot, root_vel, root_ang_vel, dof_pos,
                           dof_vel, key_body_pos, local_root_obs: bool,
                           root_height_obs: bool, dof_offsets):
    root_h = root_pos[:, 2:3]
    heading_rot = rot.calc_heading_quat_inv(root_rot)
    root_rot_obs = rot.quat_mul(heading_rot, root_rot) if local_root_obs else root_rot
    root_rot_obs = rot.quat_to_tan_norm(root_rot_obs)
    root_h_obs = root_h if root_height_obs else torch.zeros_like(root_h)
    local_root_vel = rot.quat_rotate(heading_rot, root_vel)
    local_root_ang_vel = rot.quat_rotate(heading_rot, root_ang_vel)
    local_key = rot.quat_rotate(heading_rot[:, None, :], key_body_pos - root_pos[:, None, :])
    flat_key = local_key.reshape(local_key.shape[0], -1)
    dof_obs = dof_to_obs(dof_pos, dof_offsets)
    return torch.cat([root_h_obs, root_rot_obs, local_root_vel, local_root_ang_vel,
                      dof_obs, dof_vel, flat_key], dim=-1)


def compute_humanoid_reset(progress, contact_forces, contact_mask, body_pos,
                           max_episode_length: float, enable_early_termination: bool,
                           termination_heights) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reset, terminated) int32. ``contact_mask`` (nb,) is False on the
    bodies allowed to touch the ground."""
    B = body_pos.shape[0]
    terminated = torch.zeros(B, dtype=torch.int32, device=body_pos.device)
    if enable_early_termination:
        nb = body_pos.shape[1]
        masked_forces = contact_forces[:, :nb] * contact_mask[None, :, None]
        fall_contact = torch.any((torch.abs(masked_forces) > 0.1).flatten(1), dim=-1)
        fall_height = (body_pos[..., 2] < termination_heights[None, :]) & contact_mask[None, :]
        has_fallen = fall_contact & torch.any(fall_height, dim=-1) & (progress > 1)
        terminated = has_fallen.to(torch.int32)
    reset = torch.where(progress >= max_episode_length - 1,
                        torch.ones_like(terminated), terminated)
    return reset.to(torch.int32), terminated
