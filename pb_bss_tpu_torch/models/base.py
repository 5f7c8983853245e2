"""Model base machinery: frozen dataclasses of tensors + serialization.

Same dict schema as ``pb_bss_tpu.models.base.Model`` (``to_dict`` /
``from_dict``), so a model fitted by either package loads in the other:
``from_dict`` accepts numpy arrays (e.g. a JAX model's ``to_dict()``
with its arrays converted by ``np.asarray``) and turns them into
tensors. Also the JAX package's helpers around it: ``Model.replace``,
``static_field``, ``parameter_from_dict``,
``get_trainer_class_from_model``, ``stack_parameters`` and the
reference's observation normalizers ``_unit_norm``, ``_phase_norm`` and
``_frequency_norm``.
"""
from __future__ import annotations

import dataclasses
import sys
import typing

import numpy as np
import torch

from ..ops.linalg import force_hermitian, unit_norm  # noqa: F401

__all__ = ['Model', 'modelclass', 'static_field', 'parameter_from_dict',
           'get_trainer_class_from_model', 'stack_parameters',
           '_unit_norm', 'force_hermitian', 'unit_norm', '_phase_norm',
           '_frequency_norm']


def _as_tensor(v):
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return torch.as_tensor(np.array(v))  # a writable copy
    return v


class Model:
    """Mixin giving dataclass models dict (de)serialization. Use via
    the :func:`modelclass` decorator."""

    def to_dict(self):
        ret = {}
        for k in self.__dataclass_fields__:
            v = getattr(self, k)
            ret[k] = v.to_dict() if isinstance(v, Model) else v
        return ret

    @classmethod
    def from_dict(cls, d: dict):
        """Inverse of :meth:`to_dict`; numpy arrays become tensors."""
        assert cls.__dataclass_fields__.keys() == d.keys(), (
            cls.__dataclass_fields__.keys(), d.keys())
        kwargs = {}
        for k, v in d.items():
            target = _resolve_model_type(
                cls.__dataclass_fields__[k].type, cls)
            if target is not None and isinstance(v, dict):
                kwargs[k] = target.from_dict(v)
            else:
                kwargs[k] = _as_tensor(v)
        return cls(**kwargs)

    def replace(self, **changes):
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)


def _resolve_model_type(field_type, owner_cls):
    """A dataclass field annotation as a Model subclass, or None
    (string annotations are looked up in the owner's module)."""
    if isinstance(field_type, str):
        module = sys.modules.get(owner_cls.__module__)
        field_type = getattr(module, field_type, None) if module else None
    if isinstance(field_type, type) and issubclass(field_type, Model):
        return field_type
    return None


def modelclass(cls):
    """Decorator: frozen dataclass + :class:`Model` mixin."""
    cls = dataclasses.dataclass(frozen=True, repr=True)(cls)
    if Model not in cls.__mro__:
        raise TypeError(f'{cls} must inherit from Model')
    return cls


def static_field(default=None):
    """A dataclass field of static metadata (axis tuples, fixed
    exponents). The JAX package keeps such fields out of the pytree's
    leaves; here there is no pytree, and the field is marked alike."""
    return dataclasses.field(default=default, metadata={'static': True})


def parameter_from_dict(parameter_class_or_str, d: dict):
    """Instantiate a model from its dict representation by class or by
    its name in :mod:`pb_bss_tpu_torch.models`."""
    if isinstance(parameter_class_or_str, str):
        from pb_bss_tpu_torch import models
        parameter_class_or_str = getattr(models, parameter_class_or_str)
    return parameter_class_or_str.from_dict(d)


def get_trainer_class_from_model(parameter):
    """Name-convention lookup: ``Foo`` -> ``FooTrainer``.

    >>> from pb_bss_tpu_torch.models import CACGMM
    >>> get_trainer_class_from_model(CACGMM).__name__
    'CACGMMTrainer'
    """
    from pb_bss_tpu_torch import models
    if not hasattr(parameter, '__name__'):
        parameter = parameter.__class__
    name = parameter.__name__
    assert 'Trainer' not in name, name
    return getattr(models, name + 'Trainer')


def stack_parameters(parameters: typing.List[Model]):
    """Stack structurally identical models along a new leading axis.

    >>> from pb_bss_tpu_torch.models.gaussian import SphericalGaussian
    >>> g = SphericalGaussian(mean=torch.zeros(2), covariance=torch.ones(()))
    >>> tuple(stack_parameters([g, g, g]).mean.shape)
    (3, 2)
    """
    types = {p.__class__ for p in parameters}
    assert len(types) == 1, types
    out_type = list(types)[0]
    out = {}
    for k in parameters[0].__dataclass_fields__:
        datas = [getattr(p, k) for p in parameters]
        data_types = {d.__class__ for d in datas}
        assert len(data_types) == 1, data_types
        if isinstance(datas[0], Model):
            out[k] = stack_parameters(datas)
        else:
            out[k] = torch.stack([torch.as_tensor(d) for d in datas])
    return out_type(**out)


def _unit_norm(signal, *, axis=-1, eps=1e-4, eps_style='plus', ord=None):
    """Alias of :func:`pb_bss_tpu_torch.ops.linalg.unit_norm` (the
    reference's name)."""
    return unit_norm(signal, axis=axis, eps=eps, eps_style=eps_style,
                     ord=ord)


def _phase_norm(signal, reference_channel=0):
    """Phase normalization against a reference channel. signal:
    (..., T, D) complex."""
    angles = torch.angle(
        signal[..., reference_channel:reference_channel + 1])
    return signal * torch.exp(-1j * angles)


def _frequency_norm(
        signal,
        max_sensor_distance=None, shrink_factor=1.2,
        fft_size=1024, sample_rate=16000, sound_velocity=343,
):
    """Frequency normalization: each bin's phase scaled by
    ``sound_velocity / (2 f shrink_factor max_sensor_distance)``, which
    maps the phase differences of all bins onto one range. Raises
    ``ValueError`` when the sensors are too far apart for the highest
    bin.

    signal: (F, T, D) complex STFT signal.
    """
    from ..utils import get_stft_center_frequencies
    frequency = get_stft_center_frequencies(fft_size, sample_rate)
    F = signal.shape[0]
    assert len(frequency) == F, (len(frequency), F)
    with np.errstate(divide='ignore'):
        norm_factor = sound_velocity / (
            2 * frequency * shrink_factor * max_sensor_distance
        )
    norm_factor = np.nan_to_num(norm_factor)
    if norm_factor[-1] < 1:
        raise ValueError(
            'Distance between the sensors too high: {:.2} > {:.2}'.format(
                max_sensor_distance, sound_velocity / (2 * frequency[-1])
            )
        )
    # float64: the DC bin's factor (finite by nan_to_num) overflows f32
    norm_factor = torch.as_tensor(
        norm_factor[:, None, None], dtype=torch.float64,
        device=signal.device)
    phase = torch.angle(signal).to(torch.float64) * norm_factor
    return signal.abs() * torch.exp(1j * phase).to(signal.dtype)
