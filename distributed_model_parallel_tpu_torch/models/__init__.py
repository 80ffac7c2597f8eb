"""Models of the port: the whole CNN zoo as staged unit sequences
(MobileNetV2, ResNet-18/34/50, tinycnn, and the 16 architectures of
:mod:`.zoo`), the sparse bag-of-words classifier (:mod:`.embedding`) and
the Transformer LM (:mod:`.transformer`, which has its own entry
points)."""

from __future__ import annotations

import torch

from distributed_model_parallel_tpu_torch.config import ModelConfig
from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
    build_mobilenetv2,
)
from distributed_model_parallel_tpu_torch.models.resnet import build_resnet
from distributed_model_parallel_tpu_torch.models.staged import (  # noqa: F401
    StagedModel,
    balanced_boundaries,
    merge_tree,
    params_from_jax,
    params_to_jax,
    partition_tree,
    stage_slices,
)
from distributed_model_parallel_tpu_torch.models.tinycnn import build_tinycnn
from distributed_model_parallel_tpu_torch.models.zoo import ZOO_BUILDERS

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_LAYOUT_MODELS = ("mobilenetv2", "mobilenetv2_nobn", "resnet18", "resnet34",
                  "resnet50")


def _cnn_kwargs(config: ModelConfig, axis) -> dict:
    if config.batchnorm == "sync" and axis is None:
        raise ValueError("sync BatchNorm requires an axis (the data axis' "
                         "process group)")
    if config.dtype not in DTYPES:
        raise ValueError(f"unknown compute dtype {config.dtype!r}; known: "
                         f"{', '.join(DTYPES)}")
    if config.param_dtype != "float32":
        raise ValueError(f"param_dtype {config.param_dtype!r}: the port "
                         f"keeps float32 parameters, as the JAX package "
                         f"does (no module of it reads param_dtype)")
    return dict(num_classes=config.num_classes, bn_mode=config.batchnorm,
                bn_momentum=config.bn_momentum,
                bn_epsilon=config.bn_epsilon, dtype=DTYPES[config.dtype],
                axis=axis)


def get_model(config: ModelConfig, *, seed: int = 0, device="cuda",
              axis=None):
    """Build the ``config.name`` model on ``device`` with weights from
    ``seed`` (the port's own draws of flax's default initializers).
    ``axis`` is the data axis' process group for cross-replica BatchNorm
    statistics; only consulted when ``config.batchnorm == "sync"``.
    ``extra={"input_layout": "imagenet"}`` selects the ImageNet stride
    table of MobileNetV2 and the ImageNet stem of ResNet (every other
    family refuses the key, as the JAX package does); tinycnn takes
    ``width``/``depth`` from ``extra``. ``embedding_bow`` returns its
    :class:`~.embedding.BowConfig` (fields from ``extra``), as the JAX
    registry does: its parameters are a flat dict
    (:func:`~.embedding.init_params`). The 16 names of
    :data:`~.zoo.ZOO_BUILDERS` (VGG, PreActResNet, SENet, GoogLeNet,
    DenseNet, ResNeXt, MobileNet v1, DPN, the ShuffleNets, EfficientNet,
    RegNetX, SimpleDLA) take no ``extra``; the LM has its own entry
    (``models/transformer.py``)."""
    from distributed_model_parallel_tpu_torch.models.transformer import (
        resolve_device,
    )

    name = config.name
    extra = dict(config.extra)
    layout = extra.pop("input_layout", "cifar")
    if "input_layout" in config.extra and name not in _LAYOUT_MODELS:
        raise ValueError(f"model {name!r} takes no input_layout (only "
                         f"mobilenetv2/resnet18/34/50 do)")
    if name in ("mobilenetv2", "mobilenetv2_nobn"):
        kw = _cnn_kwargs(config, axis)
        if name.endswith("_nobn"):
            kw["bn_mode"] = "none"
        if extra:
            raise ValueError(f"mobilenetv2 takes no extra {sorted(extra)}")
        model = build_mobilenetv2(**kw, input_layout=layout)
    elif name in ("resnet18", "resnet34", "resnet50"):
        if extra:
            raise ValueError(f"{name} takes no extra {sorted(extra)}")
        model = build_resnet(name, **_cnn_kwargs(config, axis),
                             input_layout=layout)
    elif name == "embedding_bow":
        from distributed_model_parallel_tpu_torch.models.embedding import (
            build_embedding_bow,
        )

        return build_embedding_bow(config)
    elif name == "tinycnn":
        model = build_tinycnn(**_cnn_kwargs(config, axis), **extra)
    elif name in ZOO_BUILDERS:
        if extra:
            raise ValueError(f"{name} takes no extra {sorted(extra)}")
        model = ZOO_BUILDERS[name](**_cnn_kwargs(config, axis))
    elif name == "transformer":
        raise ValueError("the Transformer LM is built through "
                         "models/transformer.py (init_params, "
                         "LMTrainer), not get_model")
    else:
        raise KeyError(f"unknown model {name!r}; known: mobilenetv2[_nobn], "
                       f"resnet18/34/50, tinycnn, embedding_bow, "
                       f"{', '.join(sorted(ZOO_BUILDERS))} (the LM: "
                       f"models/transformer.py)")
    model.reset_parameters(seed)
    return model.to(resolve_device(device))
