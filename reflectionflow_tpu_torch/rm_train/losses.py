"""Reward-model pairwise losses (the Bradley-Terry family).

Counterpart of `reflectionflow_tpu/rm_train/losses.py`:

  * chosen_label per (pair, dim): 1 = A chosen, -1 = B chosen, 0 = tied,
    22 = invalid;
  * losses: bt, margin (the MOS-score margin), constant_margin (0.57),
    scaled, reg (squared error to score - 3), btt (Bradley-Terry with ties,
    k = 5);
  * tied pairs are masked out, except in btt and reg, which use their own
    masks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INVALID_LABEL = 22


def convert_A_B_to_chosen_rejected(rewards_A, rewards_B, scores_A, scores_B, chosen_label):
    """All inputs (B, N) -> (chosen, rejected, s_chosen, s_rejected,
    nontied_mask, valid_mask), the masks in fp32."""
    chosen_mask = chosen_label == 1
    rewards_chosen = torch.where(chosen_mask, rewards_A, rewards_B)
    rewards_rejected = torch.where(chosen_mask, rewards_B, rewards_A)
    scores_chosen = torch.where(chosen_mask, scores_A, scores_B)
    scores_rejected = torch.where(chosen_mask, scores_B, scores_A)
    nontied = ((chosen_label == 1) | (chosen_label == -1)).float()
    valid = (chosen_label != INVALID_LABEL).float()
    return rewards_chosen, rewards_rejected, scores_chosen, scores_rejected, nontied, valid


def reward_loss(rewards_A: torch.Tensor, rewards_B: torch.Tensor, scores_A: torch.Tensor,
                scores_B: torch.Tensor, chosen_label: torch.Tensor, loss_type: str = "bt") -> torch.Tensor:
    """The mean masked loss over (B, N) rewards; any other `loss_type` raises."""
    rc, rr, sc, sr, nontied, valid = convert_A_B_to_chosen_rejected(
        rewards_A, rewards_B, scores_A, scores_B, chosen_label)
    margin = sc - sr
    logsig = F.logsigmoid

    if loss_type == "bt":
        loss, mask = -logsig(rc - rr), nontied
    elif loss_type == "margin":
        loss, mask = -logsig(rc - rr - margin), nontied
    elif loss_type == "constant_margin":
        loss, mask = -logsig(rc - rr - 0.57), nontied
    elif loss_type == "scaled":
        loss, mask = -margin * logsig(rc - rr), nontied
    elif loss_type == "reg":
        rewards = torch.stack([rewards_A, rewards_B], dim=1)
        scores = torch.stack([scores_A, scores_B], dim=1)
        mask = (scores != 0.0).float()
        loss = (rewards - (scores - 3.0)) ** 2
    elif loss_type == "btt":
        k = 5.0
        log_k = math.log(k)
        log_k2_sub_1 = math.log(k**2 - 1)
        bt = -logsig(rc - rr - log_k)
        same = -logsig(rc - rr - log_k) - logsig(rr - rc - log_k) - log_k2_sub_1
        loss, mask = bt * nontied + same * (1 - nontied), valid
    else:
        raise NotImplementedError(f"loss type {loss_type}")
    return torch.mean(loss * mask)


def pairwise_accuracy(rewards_A, rewards_B, chosen_label) -> torch.Tensor:
    """Per-dim accuracy over the non-tied pairs (N,), in fp32."""
    nontied = (chosen_label == 1) | (chosen_label == -1)
    pred_A = rewards_A > rewards_B
    correct = torch.where(chosen_label == 1, pred_A, ~pred_A)
    denom = nontied.sum(dim=0).clamp_min(1)
    return (correct & nontied).sum(dim=0).float() / denom.float()


def convert_gsb_labels(gsb: str) -> int:
    """A Good/Same/Bad CSV label -> chosen_label."""
    table = {"G": 1, "A": 1, "good": 1, "B": -1, "bad": -1, "S": 0, "same": 0}
    return table.get(gsb, INVALID_LABEL)
