"""The EM loop shared by the mixture trainers (counterpart of
``pb_bss_tpu.models._em``).

Every mixture trainer follows the same skeleton: start from
affiliations, then alternate ``model = m_step(affiliation)`` /
``affiliation = e_step(model)`` with an optional inline permutation
alignment after each E-step, returning after an M-step. The JAX package
runs it as one ``lax.scan``; here it is a plain Python loop.
"""
from __future__ import annotations

import inspect

from .mixture_model_utils import apply_inline_permutation_alignment

__all__ = ['run_em']


def run_em(*, affiliation, iterations, m_step, e_step, aligner=None,
           weight_constant_axis=(-1,)):
    """Run ``iterations`` M-steps with an E-step between each two.

    Args:
        affiliation: initial responsibilities (..., K, N).
        iterations: number of M-steps (> 0).
        m_step: affiliation -> model. A two-parameter
            ``m_step(affiliation, previous_model)`` receives the previous
            model (None on the first call), for warm-started M-step
            solvers.
        e_step: model -> affiliation.
        aligner: optional inline permutation aligner applied to each
            E-step's output (requires (F, K, T) affiliations).
        weight_constant_axis: only used to validate the aligner's use.
    Returns:
        The fitted model.
    """
    assert iterations > 0, iterations
    if len(inspect.signature(m_step).parameters) < 2:
        one_parameter = m_step
        m_step = lambda affiliation, _model: one_parameter(affiliation)
    model = m_step(affiliation, None)
    for _ in range(iterations - 1):
        affiliation = e_step(model)
        if aligner is not None:
            affiliation = apply_inline_permutation_alignment(
                affiliation, weight_constant_axis=weight_constant_axis,
                aligner=aligner)
        model = m_step(affiliation, model)
    return model
