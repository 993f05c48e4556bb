"""File-driven evaluation datasets (port of the annotation builders of
``ecoflap_tpu/data/datasets.py`` that the BLIP-2 evaluation reaches;
reference LAVIS/lavis/datasets/builders/__init__.py:10-49).

A builder takes ``{"vis_root": ..., "ann_paths": [...]}``, loads LAVIS-style
JSON annotations and yields plain dict samples; ``batch_iterator`` stacks
them. Registered: ``coco_vqa``, ``ok_vqa``, ``aok_vqa`` (VQA), ``gqa``,
``coco_caption``, ``nocaps`` (captions), ``coco_retrieval``, ``flickr30k``
(retrieval), ``nlvr``, ``prefix_conceptual_caption_3m``/``_12m``
(calibration pairs), the image folders ``imagenet`` and ``cifar100``
(``ImageFolderDataset``; the 11 CoOp dataset names register in
``data/coop.py``), and the text sources ``c4`` (a ``{"text": ...}`` jsonl)
and ``wikitext2`` (a raw text file). The data must be on local disk.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ecoflap_tpu_torch.core.registry import registry


def _load_annotations(ann_paths: Sequence[str]) -> List[Dict]:
    out: List[Dict] = []
    for p in ann_paths:
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"annotation file {p!r} not found — datasets must be on local disk")
        with open(p) as f:
            data = json.load(f)
        if isinstance(data, dict) and "annotations" in data:
            data = data["annotations"]
        out.extend(data)
    return out


class AnnotationDataset:
    """A LAVIS-style JSON list of dicts, images read on demand."""

    def __init__(self, cfg: Dict[str, Any], vis_processor=None, text_processor=None):
        self.cfg = cfg
        self.vis_root = cfg.get("vis_root", "")
        self.annotation = _load_annotations(cfg.get("ann_paths", []))
        self.vis_processor = vis_processor
        self.text_processor = text_processor or (lambda x: x)

    def __len__(self) -> int:
        return len(self.annotation)

    def _load_image(self, rel_path: str) -> np.ndarray:
        from PIL import Image

        img = Image.open(os.path.join(self.vis_root, rel_path)).convert("RGB")
        if self.vis_processor is not None:
            return self.vis_processor(img)
        return np.asarray(img, np.float32) / 255.0


@registry.register("builder", "coco_vqa")
@registry.register("builder", "ok_vqa")
@registry.register("builder", "aok_vqa")
class VQADataset(AnnotationDataset):
    def __getitem__(self, i: int) -> Dict[str, Any]:
        ann = self.annotation[i]
        return {
            "image": self._load_image(ann["image"]),
            "text_input": self.text_processor(ann["question"]),
            "gt_answers": ann.get("answer", ann.get("answers", [])),
            "question_id": ann.get("question_id", i),
        }


@registry.register("builder", "gqa")
class GQADataset(VQADataset):
    def __getitem__(self, i: int) -> Dict[str, Any]:
        ann = self.annotation[i]
        ans = ann.get("answer", ann.get("fullAnswer", ""))
        if isinstance(ans, list):
            ans = ans[0] if ans else ""
        return {
            "image": self._load_image(ann["image"]),
            "text_input": self.text_processor(ann["question"]),
            "gt": ans,
            "question_id": ann.get("question_id", i),
        }


@registry.register("builder", "coco_caption")
@registry.register("builder", "nocaps")
class CaptionDataset(AnnotationDataset):
    def __getitem__(self, i: int) -> Dict[str, Any]:
        ann = self.annotation[i]
        caps = ann.get("caption", [])
        if isinstance(caps, str):
            caps = [caps]
        return {
            "image": self._load_image(ann["image"]),
            "gt_captions": [self.text_processor(c) for c in caps],
            "image_id": ann.get("image_id", i),
        }


@registry.register("builder", "coco_retrieval")
@registry.register("builder", "flickr30k")
class RetrievalDataset(CaptionDataset):
    pass


@registry.register("builder", "nlvr")
class NLVRDataset(AnnotationDataset):
    def __getitem__(self, i: int) -> Dict[str, Any]:
        ann = self.annotation[i]
        return {
            "image0": self._load_image(ann["images"][0]),
            "image1": self._load_image(ann["images"][1]),
            "text_input": self.text_processor(ann["sentence"]),
            "label": 1 if str(ann.get("label", "")).lower() == "true" else 0,
        }


@registry.register("builder", "prefix_conceptual_caption_3m")
@registry.register("builder", "prefix_conceptual_caption_12m")
class PrefixCaptionDataset(AnnotationDataset):
    """(image, caption) calibration pairs; the prefix/suffix split happens in
    ``calibration.build_vl_calibration_batch`` (datasets.py:199-211)."""

    def __getitem__(self, i: int) -> Dict[str, Any]:
        ann = self.annotation[i]
        return {
            "image": self._load_image(ann["image"]),
            "caption": self.text_processor(ann["caption"]),
        }


@registry.register("builder", "c4")
class C4Dataset:
    """C4 documents from a local jsonl of ``{"text": ...}`` lines
    (``cfg["jsonl_path"]``; datasets.py:214-245). The JAX builder's other
    source, allenai/c4 through the HF datasets cache, needs a download: it
    raises here."""

    def __init__(self, cfg: Dict[str, Any], text_processor=None, **_):
        self.text_processor = text_processor or (lambda x: x)
        path = cfg.get("jsonl_path")
        if not path:
            raise RuntimeError(
                "c4 needs cfg['jsonl_path'], a local jsonl of {\"text\": ...} lines: "
                "the HF datasets cache of allenai/c4 would need a download")
        with open(path) as f:
            self.texts = [json.loads(line)["text"] for line in f if line.strip()]

    def __len__(self):
        return len(self.texts)

    def __getitem__(self, i):
        return {"text": self.text_processor(self.texts[i])}


@registry.register("builder", "wikitext2")
class WikiTextDataset:
    """A raw text file, one token stream for perplexity (datasets.py:255-266)."""

    def __init__(self, cfg: Dict[str, Any], **_):
        with open(cfg["text_path"]) as f:
            self.text = f.read()

    def token_stream(self, tokenizer) -> np.ndarray:
        ids, _ = tokenizer([self.text], max_length=10 ** 9, add_eos=False, pad=False)
        return np.asarray(ids[0], np.int32)


@registry.register("builder", "imagenet")
@registry.register("builder", "cifar100")
class ImageFolderDataset:
    """Class-subdirectory layout, labels the sorted directory index
    (datasets.py:133-163). PIL is imported where an image is opened."""

    def __init__(self, cfg: Dict[str, Any], vis_processor=None, **_):
        root = cfg["vis_root"]
        self.vis_processor = vis_processor
        self.samples: List = []
        self.classnames: List[str] = []
        for ci, cls in enumerate(sorted(os.listdir(root))):
            cdir = os.path.join(root, cls)
            if not os.path.isdir(cdir):
                continue
            self.classnames.append(cls)
            for fn in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fn), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        if self.vis_processor is not None:
            img = self.vis_processor(img)
        else:
            img = np.asarray(img, np.float32) / 255.0
        return {"image": img, "label": label}


def batch_iterator(dataset, batch_size: int,
                   collate: Optional[Callable[[List[Dict]], Dict]] = None,
                   limit: Optional[int] = None, drop_last: bool = False
                   ) -> Iterator[Dict]:
    """The reference's DataLoader, on the host: ``batch_size`` samples at a
    time through ``collate`` (``_collate`` by default)."""
    collate = collate or _collate
    n = len(dataset) if limit is None else min(limit, len(dataset))
    buf: List[Dict] = []
    for i in range(n):
        buf.append(dataset[i])
        if len(buf) == batch_size:
            yield collate(buf)
            buf = []
    if buf and not drop_last:
        yield collate(buf)


def _collate(samples: List[Dict]) -> Dict:
    """Arrays stacked, numbers to an array, anything else as a list."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[k] = np.asarray(vals)
        else:
            out[k] = vals
    return out


# the CoOp builders (caltech101, dtd, eurosat, ...) register on import; they
# subclass ImageFolderDataset, so the import stays at the bottom
from ecoflap_tpu_torch.data import coop as _coop  # noqa: E402,F401
