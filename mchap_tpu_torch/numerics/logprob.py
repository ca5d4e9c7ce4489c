"""Log-space probability arithmetic (PyTorch).

Port of ``mchap_tpu/numerics/logprob.py`` (reference
``mchap/jitutils.py:6-92``, 174-177): vectorised ``logsumexp`` reductions
in place of pairwise ``add_log_prob`` loops, and categorical draws from
an explicit ``torch.Generator`` in place of ``jax.random`` keys.
"""

import math

import torch


def logsumexp(a, axis=None, where=None):
    """Numerically stable log(sum(exp(a))), -inf entries allowed; entries
    where ``where`` is False are left out.  Reference ``sum_log_probs``
    (jitutils.py:29-47) over an axis (None: all)."""
    a = torch.as_tensor(a)
    if where is not None:
        a = torch.where(torch.as_tensor(where), a, -math.inf)
    if axis is None:
        return torch.logsumexp(a.reshape(-1), dim=0)
    return torch.logsumexp(a, dim=axis)


def normalise_log_probs(llks, axis=-1):
    """Normalised probabilities from log-probabilities; reference
    ``normalise_log_probs`` (jitutils.py:50-74)."""
    llks = torch.as_tensor(llks)
    return torch.exp(llks - logsumexp(llks, axis=axis)[..., None])


def random_choice_log(generator, logits):
    """Categorical draw (over the last axis) from unnormalised
    log-probabilities, as a Gumbel arg-max on ``generator``'s uniforms;
    replaces reference ``random_choice`` over normalised probabilities
    (jitutils.py:77-92)."""
    logits = torch.as_tensor(logits)
    u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype,
                   device=logits.device).clamp_(min=1e-300)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def random_choice(generator, probabilities):
    """Categorical draw (over the last axis) from normalised
    probabilities, by inverse CDF on the cumulative sum so that a
    zero-probability option is never drawn; reference ``random_choice``
    (jitutils.py:77-92)."""
    probabilities = torch.as_tensor(probabilities)
    cdf = torch.cumsum(probabilities, dim=-1)
    u = torch.rand(probabilities.shape[:-1], generator=generator, dtype=cdf.dtype,
                   device=cdf.device)
    return torch.sum(cdf <= u[..., None] * cdf[..., -1:], dim=-1)


def natural_log_to_log10(x):
    """Reference: jitutils.py:174-177."""
    return x * math.log10(math.e)
