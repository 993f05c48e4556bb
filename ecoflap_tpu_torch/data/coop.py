"""CoOp zero-shot evaluation surface: the 11-dataset sweep (the port's own
copy of ``ecoflap_tpu/data/coop.py``).

The reference's CoOp result is defined over 11 datasets
(CoOp/scripts/coop/ecoflap_wanda.sh:16: caltech101 dtd eurosat fgvc_aircraft
food101 imagenet oxford_flowers oxford_pets stanford_cars sun397 ucf101),
each with its own single prompt template (``CUSTOM_TEMPLATES``,
CoOp/trainers/zsclip.py:13-29 — public constants from the CLIP paper) and
classnames derived from the dataset on disk (split JSONs in the reference;
class-subdirectory names here), with per-dataset display-name fixups
(caltech101/eurosat ``NEW_CNAMES``, CoOp/datasets/{caltech101,eurosat}.py).

Data contract: one imagefolder root per dataset (class subdirectories),
like the rest of the image datasets. Each dataset name is a
registered builder; ``classnames`` come back CoOp-normalized (underscores
-> spaces, renames applied, ignored dirs dropped).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.data.datasets import ImageFolderDataset

# CoOp/trainers/zsclip.py:13-29 (keys = the launcher's dataset names)
COOP_TEMPLATES: Dict[str, str] = {
    "oxford_pets": "a photo of a {}, a type of pet.",
    "oxford_flowers": "a photo of a {}, a type of flower.",
    "fgvc_aircraft": "a photo of a {}, a type of aircraft.",
    "dtd": "{} texture.",
    "eurosat": "a centered satellite photo of {}.",
    "stanford_cars": "a photo of a {}.",
    "food101": "a photo of {}, a type of food.",
    "sun397": "a photo of a {}.",
    "caltech101": "a photo of a {}.",
    "ucf101": "a photo of a person doing {}.",
    "imagenet": "a photo of a {}.",
    "imagenet_sketch": "a photo of a {}.",
    "imagenetv2": "a photo of a {}.",
    "imagenet_a": "a photo of a {}.",
    "imagenet_r": "a photo of a {}.",
}

# the launcher's 11-dataset sweep (ecoflap_wanda.sh:16)
COOP_DATASETS: List[str] = [
    "caltech101", "dtd", "eurosat", "fgvc_aircraft", "food101", "imagenet",
    "oxford_flowers", "oxford_pets", "stanford_cars", "sun397", "ucf101",
]

# CoOp/datasets/caltech101.py:10-16
CALTECH_IGNORED = ("BACKGROUND_Google", "Faces_easy")
CALTECH_RENAMES = {
    "airplanes": "airplane",
    "Faces": "face",
    "Leopards": "leopard",
    "Motorbikes": "motorbike",
}
# CoOp/datasets/eurosat.py:10-21
EUROSAT_RENAMES = {
    "AnnualCrop": "Annual Crop Land",
    "Forest": "Forest",
    "HerbaceousVegetation": "Herbaceous Vegetation Land",
    "Highway": "Highway or Road",
    "Industrial": "Industrial Buildings",
    "Pasture": "Pasture Land",
    "PermanentCrop": "Permanent Crop Land",
    "Residential": "Residential Buildings",
    "River": "River",
    "SeaLake": "Sea or Lake",
}

_RENAMES: Dict[str, Dict[str, str]] = {
    "caltech101": CALTECH_RENAMES,
    "eurosat": EUROSAT_RENAMES,
}
_IGNORED: Dict[str, Sequence[str]] = {"caltech101": CALTECH_IGNORED}


def normalize_classname(dataset: str, raw: str) -> str:
    """Folder/split name -> CoOp display classname (renames + ``_``->space,
    zsclip.py:43 ``c.replace("_", " ")``)."""
    remap = _RENAMES.get(dataset, {})
    return remap.get(raw, raw).replace("_", " ")


def coop_prompts(dataset: str, classnames: Sequence[str]) -> List[str]:
    """One prompt per class from the dataset's CUSTOM_TEMPLATE
    (zsclip.py:42-43; classnames must already be display-normalized)."""
    temp = COOP_TEMPLATES[dataset]
    return [temp.format(c) for c in classnames]


class CoopImageFolder(ImageFolderDataset):
    """Imagefolder with CoOp classname normalization.

    Construction matches the plain builder (class subdirectories, labels =
    sorted dir index) but drops ignored dirs and rewrites ``classnames`` to
    the display names the prompt templates expect."""

    dataset_name = "imagenet"

    def __init__(self, cfg, vis_processor=None, **kw):
        super().__init__(cfg, vis_processor=vis_processor, **kw)
        ignored = set(_IGNORED.get(self.dataset_name, ()))
        if ignored:
            keep = [i for i, c in enumerate(self.classnames)
                    if c not in ignored]
            old_to_new = {o: n for n, o in enumerate(keep)}
            self.samples = [(p, old_to_new[l]) for p, l in self.samples
                            if l in old_to_new]
            self.classnames = [self.classnames[i] for i in keep]
        self.classnames = [normalize_classname(self.dataset_name, c)
                           for c in self.classnames]


def _register() -> None:
    for name in COOP_DATASETS:
        if name == "imagenet":
            continue  # already a builder (data/datasets.py)
        cls = type(f"Coop_{name}", (CoopImageFolder,),
                   {"dataset_name": name})
        registry.register("builder", name, cls)


_register()
