"""Build the port's objects from plain numpy fields ("weights carried
across").

The JAX package's ``Scenario`` and ``RAConstants`` are dataclasses of numpy
or JAX arrays, and its FL models dicts of arrays. A caller that holds both
packages (the parity tests) turns one into a mapping of numpy arrays and
hands it here, so both packages work on the identical scenario or start
from the identical model. Nothing here imports the JAX package.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch import DTYPE, resolve_device
from repro_torch.core.cost_model import (DeviceParams, LearningParams,
                                         RAConstants, ServerParams)
from repro_torch.core.scenario import Scenario
from repro_torch.utils import tree_map


def _tensors(cls, fields: Mapping, device: torch.device):
    return cls(**{name: torch.tensor(np.asarray(value, np.float32),
                                     dtype=DTYPE, device=device)
                  for name, value in fields.items()})


def scenario_from_numpy(fields: Mapping, device=None) -> Scenario:
    """A :class:`Scenario` from a mapping with ``dev`` and ``srv`` (each a
    mapping of parameter name -> (N,) / (K,) array), ``avail``, ``dist``
    and optionally ``lp`` (mapping of LearningParams fields), ``active``,
    ``dev_xy``, ``srv_xy``, ``reach_m`` and ``max_devices``."""
    dev = resolve_device(device)

    def opt(name):
        value = fields.get(name)
        return None if value is None else np.asarray(value).copy()

    return Scenario(
        dev=_tensors(DeviceParams, fields["dev"], dev),
        srv=_tensors(ServerParams, fields["srv"], dev),
        avail=np.asarray(fields["avail"], dtype=bool).copy(),
        dist=np.asarray(fields["dist"], dtype=np.float64).copy(),
        lp=LearningParams(**fields.get("lp", {})),
        active=opt("active"),
        dev_xy=opt("dev_xy"),
        srv_xy=opt("srv_xy"),
        reach_m=(None if fields.get("reach_m") is None
                 else float(fields["reach_m"])),
        max_devices=opt("max_devices"),
    )


def ra_constants_from_numpy(fields: Mapping, device=None) -> RAConstants:
    """:class:`RAConstants` from a mapping of its field names to arrays."""
    return _tensors(RAConstants, fields, resolve_device(device))


def fl_params_from_numpy(params: Mapping, n_clients: int,
                         device=None) -> dict:
    """Client-stacked FL params from one model's params (a mapping of leaf
    name -> numpy array, as ``repro.fl`` models hold them): every client
    gets the same omega^0, as ``(n_clients, *shape)`` float32 tensors. Set
    them as ``FederatedTrainer.client_params``."""
    dev = resolve_device(device)
    return {name: torch.tensor(np.asarray(value, np.float32), dtype=DTYPE,
                               device=dev).expand(n_clients,
                                                  *np.shape(value)).clone()
            for name, value in params.items()}


def tree_from_numpy(tree, device=None):
    """A tree of tensors from nested mappings (and tuples) of numpy arrays,
    leaf for leaf, each keeping its dtype: LM params, the AdamW state
    ``{"m": ..., "v": ...}`` of ``repro.optim.adamw``, and pod-stacked
    trees of the hierarchical train step (a leading pod axis on every
    leaf) all carry across this way."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return torch.tensor(np.asarray(node), device=dev)

    return build(tree)


def lm_params_from_numpy(tree: Mapping, device=None, dtype=None) -> dict:
    """Model params from the JAX package's ``Model.init`` params as nested
    mappings of numpy arrays, leaf for leaf: an LM's (``blocks`` stacked
    along the layer axis) and an encoder-decoder's (``enc_blocks`` and
    ``dec_blocks`` stacked, ``pos_embed``). ``dtype=None`` keeps every
    leaf float32, as JAX inits them; a ``dtype`` (bfloat16 for serving)
    gives the serving copy of
    :func:`repro_torch.models.transformer.cast_params`: matrices in
    ``dtype``, norm scales, biases and ``pos_embed`` float32, the same
    numbers."""
    from repro_torch.models.transformer import cast_params
    params = tree_map(lambda t: t.to(torch.float32),
                      tree_from_numpy(tree, device))
    return params if dtype is None else cast_params(params, dtype)
