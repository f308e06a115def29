"""Loss math, the port of the JAX package's ``train/losses.py``.

The KD loss reproduces the reference (`knowledge_distillation/train.py:47-57`):

    loss = (1-α)·CE(student_logits, y)
         + α·KL( log_softmax(s/T) ‖ softmax(t/T) )·T²

with KL reduced "batchmean" (sum over classes, mean over batch). Every loss
takes a validity ``mask`` so the padded samples of a static-shape batch
contribute nothing; ``total`` is the mask's sum over the whole batch when
a rank holds only its rows of it (``parallel.mesh.GlobalView``), so the
ranks' losses sum to the global one. All math is fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(per_sample, mask, total=None):
    mask = mask.float()
    return (per_sample * mask).sum() / (mask.sum() if total is None else total).clamp(min=1.0)


def cross_entropy(logits, labels, mask=None, total=None):
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    return nll.mean() if mask is None else _masked_mean(nll, mask, total)


def kl_divergence_batchmean(student_logp, teacher_p, mask=None, total=None):
    """KL(teacher ‖ student) summed over classes, averaged over the batch."""
    teacher_logp = torch.log(teacher_p.clamp(min=1e-12))
    per_sample = (teacher_p * (teacher_logp - student_logp)).sum(dim=-1)
    return per_sample.mean() if mask is None else _masked_mean(per_sample, mask, total)


def kd_loss(student_logits, teacher_logits, labels, *, alpha, temperature, mask=None,
            total=None):
    """Returns (total, ce_part, kd_part)."""
    s = student_logits.float()
    t = teacher_logits.float()
    ce = cross_entropy(s, labels, mask, total)
    student_logp = F.log_softmax(s / temperature, dim=-1)
    teacher_p = F.softmax(t / temperature, dim=-1)
    kd = kl_divergence_batchmean(student_logp, teacher_p, mask, total) * (temperature**2)
    return (1.0 - alpha) * ce + alpha * kd, ce, kd


def sp_kd_loss(student_feats, teacher_feats, mask=None):
    """Similarity-preserving feature distillation (Tung & Mori, ICCV 2019):
    the row-L2-normalized batch Gram matrices of the penultimate features
    agree in Frobenius norm, ``||G̃_s − G̃_t||²_F / B²``. Masked rows are
    zeroed in both Grams and B counts the valid rows."""
    f_s = student_feats.float()
    f_t = teacher_feats.float().detach()
    if mask is not None:
        m = mask.float()[:, None]
        f_s, f_t = f_s * m, f_t * m
        b = mask.float().sum().clamp(min=1.0)
    else:
        b = torch.tensor(float(f_s.shape[0]), device=f_s.device)

    def norm_gram(f):
        g = f @ f.T
        return g / torch.linalg.vector_norm(g, dim=1, keepdim=True).clamp(min=1e-12)

    return ((norm_gram(f_s) - norm_gram(f_t)) ** 2).sum() / (b * b)


def masked_accuracy(logits, labels, mask=None, total=None):
    correct = (logits.argmax(dim=-1) == labels.long()).float()
    return correct.mean() if mask is None else _masked_mean(correct, mask, total)
