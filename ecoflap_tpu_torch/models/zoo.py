"""The model zoo: ``load_model`` and ``load_model_and_preprocess`` (port of
``ecoflap_tpu/models/zoo.py``; reference
``lavis.models.load_model_and_preprocess(name, model_type, is_eval,
device)``, LAVIS/lavis/models/__init__.py:91-216).

Each of the JAX zoo's twelve names is registered under the ``model`` kind of
the port's registry with the JAX model types (the reference's names where
they exist, plus ``small`` and ``tiny``). A loader builds the family's
``nn.Module`` from the random init at ``seed`` or from a reference-named
``.pth`` (``ckpt``, through the port's loaders) and returns a
:class:`ModelBundle`; the processors come back as ``{"train", "eval"}``
dicts in the JAX zoo's layout (zoo.py:304-346).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ecoflap_tpu_torch.core.registry import registry


@dataclass
class ModelBundle:
    """What ``load_model`` returns: the model, ready for the pruning core
    (``make_adapter()`` -> ``load_pruner``) or an evaluation."""

    name: str
    model_type: str
    cfg: Any
    model: nn.Module
    adapter_factory: Callable[..., Any]
    extras: Dict[str, Any] = field(default_factory=dict)

    def make_adapter(self, **kw):
        return self.adapter_factory(self.model, **kw)


def _auto_dtype(model_type: str, dtype) -> torch.dtype:
    if dtype is not None:
        return dtype
    return torch.float32 if model_type == "tiny" else torch.bfloat16


def _resolve(table: Dict[str, Callable[[], Any]], name: str, model_type: str):
    if model_type not in table:
        raise KeyError(f"{name}: unknown model_type {model_type!r} "
                       f"(available: {sorted(table)})")
    return table[model_type]()


def _build(mod, cfg, model_type, dtype, ckpt, seed, device, *args, load=None):
    """``mod.build_model`` at ``seed``, or its storage filled from ``ckpt``."""
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    model = mod.build_model(cfg, *args, device=device, dtype=_auto_dtype(model_type, dtype),
                            seed=None if ckpt else seed)
    if ckpt:
        (load or load_into)(model, load_torch_checkpoint(ckpt))
    return model


def load_blip2_t5(model_type: str = "pretrain_flant5xl", *, dtype=None,
                  ckpt: Optional[str] = None, seed: int = 0, device=None) -> ModelBundle:
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models import t5 as t5_mod

    def xxl():
        c = blip2.blip2_flant5xl()
        return type(c)(vit=c.vit, t5=t5_mod.flan_t5_xxl(), qformer=c.qformer)

    table = {"pretrain_flant5xl": blip2.blip2_flant5xl,
             "caption_coco_flant5xl": blip2.blip2_flant5xl,
             "pretrain_flant5xxl": xxl, "small": blip2.blip2_small,
             "tiny": blip2.tiny_config}
    cfg = _resolve(table, "blip2_t5", model_type)
    model = _build(blip2, cfg, model_type, dtype, ckpt, seed, device)
    return ModelBundle("blip2_t5", model_type, cfg, model, blip2.make_adapter,
                       extras={"generate": model.generate})


def load_t5(model_type: str = "flant5xl", *, dtype=None, ckpt: Optional[str] = None,
            seed: int = 0, device=None) -> ModelBundle:
    from ecoflap_tpu_torch.models import t5 as t5_mod

    table = {"flant5xl": t5_mod.flan_t5_xl, "flant5xxl": t5_mod.flan_t5_xxl,
             "flant5base": t5_mod.flan_t5_base, "small": t5_mod.flan_t5_base,
             "tiny": t5_mod.tiny_config}
    cfg = _resolve(table, "t5", model_type)
    model = _build(t5_mod, cfg, model_type, dtype, ckpt, seed, device)
    return ModelBundle("t5", model_type, cfg, model, t5_mod.make_adapter)


def _load_clip(name: str, model_type: str, dtype, ckpt, seed, device) -> ModelBundle:
    from ecoflap_tpu_torch.models import clip as clip_mod

    eva = name == "eva_clip"
    table = {("EVA-CLIP-g" if eva else "ViT-B-16"):
             (clip_mod.eva_clip_g if eva else clip_mod.vit_b16),
             "small": lambda: clip_mod.small_config(eva=eva),
             "tiny": lambda: clip_mod.tiny_config(eva=eva)}
    cfg = _resolve(table, name, model_type)
    model = _build(clip_mod, cfg, model_type, dtype, ckpt, seed, device)
    return ModelBundle(name, model_type, cfg, model, clip_mod.make_adapter)


def load_clip(model_type: str = "ViT-B-16", *, dtype=None, ckpt: Optional[str] = None,
              seed: int = 0, device=None) -> ModelBundle:
    return _load_clip("clip", model_type, dtype, ckpt, seed, device)


def load_eva_clip(model_type: str = "EVA-CLIP-g", *, dtype=None,
                  ckpt: Optional[str] = None, seed: int = 0, device=None) -> ModelBundle:
    return _load_clip("eva_clip", model_type, dtype, ckpt, seed, device)


def _load_blip1(kind: str, model_type: str, dtype, ckpt, seed, device) -> ModelBundle:
    """The UPop BLIP heads share a config; a ``ckpt`` overrides the init
    tensors it holds (UPop's strict=False load, blip.py:439)."""
    from ecoflap_tpu_torch.models import blip1
    from ecoflap_tpu_torch.utils.checkpoint import load_blip1

    table = {"base_coco": blip1.blip_base, "base": blip1.blip_base,
             "small": blip1.blip_base, "tiny": blip1.tiny_config}
    cfg = _resolve(table, kind, model_type)
    model = blip1.build_model(cfg, kind, device=device,
                              dtype=_auto_dtype(model_type, dtype), seed=seed)
    if ckpt:
        from ecoflap_tpu_torch.utils.checkpoint import load_torch_checkpoint

        load_blip1(model, load_torch_checkpoint(ckpt))
    return ModelBundle(kind, model_type, cfg, model, blip1.make_adapter)


def load_blip_caption(model_type: str = "base_coco", **kw) -> ModelBundle:
    return _load_blip1("blip_caption", model_type, kw.get("dtype"), kw.get("ckpt"),
                       kw.get("seed", 0), kw.get("device"))


def load_blip_vqa(model_type: str = "base", **kw) -> ModelBundle:
    return _load_blip1("blip_vqa", model_type, kw.get("dtype"), kw.get("ckpt"),
                       kw.get("seed", 0), kw.get("device"))


def load_blip_nlvr(model_type: str = "base", **kw) -> ModelBundle:
    return _load_blip1("blip_nlvr", model_type, kw.get("dtype"), kw.get("ckpt"),
                       kw.get("seed", 0), kw.get("device"))


def load_blip_retrieval(model_type: str = "base", **kw) -> ModelBundle:
    return _load_blip1("blip_retrieval", model_type, kw.get("dtype"), kw.get("ckpt"),
                       kw.get("seed", 0), kw.get("device"))


def load_blip2_opt(model_type: str = "pretrain_opt2.7b", *, dtype=None,
                   ckpt: Optional[str] = None, seed: int = 0, device=None) -> ModelBundle:
    from ecoflap_tpu_torch.models import blip2_opt

    table = {"pretrain_opt2.7b": blip2_opt.blip2_opt2_7b,
             "caption_coco_opt2.7b": blip2_opt.blip2_opt2_7b,
             "tiny": blip2_opt.tiny_config}
    cfg = _resolve(table, "blip2_opt", model_type)
    model = _build(blip2_opt, cfg, model_type, dtype, ckpt, seed, device)
    return ModelBundle("blip2_opt", model_type, cfg, model, blip2_opt.make_adapter,
                       extras={"generate": model.generate})


def load_llama(model_type: str = "7b", *, dtype=None, ckpt: Optional[str] = None,
               seed: int = 0, device=None) -> ModelBundle:
    from ecoflap_tpu_torch.models import llama

    table = {"7b": llama.llama_7b, "open_llama_3b": llama.open_llama_3b,
             "small": llama.open_llama_3b, "tiny": llama.tiny_config}
    cfg = _resolve(table, "llama", model_type)
    model = _build(llama, cfg, model_type, dtype, ckpt, seed, device)
    return ModelBundle("llama", model_type, cfg, model, llama.make_adapter)


def load_classifier(name: str):
    def _load(model_type: str = "full", *, dtype=None, ckpt: Optional[str] = None,
              seed: int = 0, device=None) -> ModelBundle:
        from ecoflap_tpu_torch.models import classifiers

        cfg = classifiers.build(name, model_type)
        model = _build(classifiers, cfg, model_type, dtype, ckpt, seed, device)
        factory = (classifiers.make_vit_classifier_adapter if name == "deit"
                   else classifiers.make_convnext_adapter)
        return ModelBundle(name, model_type, cfg, model, factory,
                           extras={"img_size": cfg.img_size,
                                   "num_classes": classifiers.num_classes(cfg)})

    return _load


LOADERS: Dict[str, Callable[..., ModelBundle]] = {
    "blip2_t5": load_blip2_t5, "t5": load_t5, "clip": load_clip,
    "eva_clip": load_eva_clip, "blip_caption": load_blip_caption,
    "blip_vqa": load_blip_vqa, "blip_nlvr": load_blip_nlvr,
    "blip_retrieval": load_blip_retrieval, "blip2_opt": load_blip2_opt,
    "llama": load_llama, "deit": load_classifier("deit"),
    "convnext": load_classifier("convnext"),
}

for _name, _fn in LOADERS.items():
    registry.register("model", _name, _fn)


def _img_size(cfg) -> int:
    for attr in ("vit", "visual", "eva_visual"):
        sub = getattr(cfg, attr, None)
        if sub is not None and hasattr(sub, "img_size"):
            return sub.img_size
    return getattr(cfg, "img_size", 224)


def processors(name: str, cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(vis, txt) processors keyed ``train`` / ``eval``, the families'
    default preprocess trees (zoo.py:304-346)."""
    from ecoflap_tpu_torch.data.processors import (
        BlipImageTrainProcessor,
        CaptionProcessor,
        ImageEvalProcessor,
        ImageTrainProcessor,
        QuestionProcessor,
    )

    s = _img_size(cfg)
    if name in ("clip", "eva_clip"):
        # clip_image_eval serves both splits (clip_processors.py:19-62)
        eval_p = ImageEvalProcessor(image_size=s)
        return {"train": eval_p, "eval": eval_p}, {"train": str, "eval": str}
    if name in ("llama", "t5"):
        return {"train": None, "eval": None}, {"train": str, "eval": str}
    if name in ("deit", "convnext"):
        return ({"train": ImageTrainProcessor(image_size=s),
                 "eval": ImageEvalProcessor(image_size=s)},
                {"train": str, "eval": str})
    txt = QuestionProcessor() if name == "blip_vqa" else CaptionProcessor()
    train_cls = BlipImageTrainProcessor if name.startswith("blip_") else ImageTrainProcessor
    return ({"train": train_cls(image_size=s), "eval": ImageEvalProcessor(image_size=s)},
            {"train": txt, "eval": txt})


def load_model(name: str, model_type: Optional[str] = None, *, dtype=None,
               ckpt: Optional[str] = None, seed: int = 0, device=None) -> ModelBundle:
    """The registered loader of ``name`` at ``model_type`` (its default
    when None) on ``device`` (the card unless ``"cpu"``)."""
    loader = registry.get_model_class(name)
    kw = dict(dtype=dtype, ckpt=ckpt, seed=seed, device=device)
    return loader(model_type, **kw) if model_type else loader(**kw)


def load_model_and_preprocess(name: str, model_type: Optional[str] = None,
                              is_eval: bool = True, *, dtype=None,
                              ckpt: Optional[str] = None, seed: int = 0, device=None):
    """``(bundle, vis_processors, txt_processors)``, the reference contract
    (models/__init__.py:177-216); ``is_eval`` puts the model in eval mode,
    else in train mode."""
    bundle = load_model(name, model_type, dtype=dtype, ckpt=ckpt, seed=seed, device=device)
    bundle.model.train(not is_eval)
    vis, txt = processors(name, bundle.cfg)
    return bundle, vis, txt
