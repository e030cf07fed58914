"""Semantic-mask label utilities (counterpart of
``boostmvsnerfs_tpu/utils/masks.py``).

Equivalent of the reference ``lib/utils/mask_utils.py`` (323 LoC, unused by
the main pipeline): the ADE20k-150 semantic segmentation label ids (public
dataset metadata — some names keep the dataset's trailing spaces) plus the
binary person/human mapping, with id<->name lookups and a vectorized
label-map -> binary-mask helper for masked evaluation of user captures.
"""

from __future__ import annotations

import numpy as np

# ADE20k SceneParse150 class names, index = label id (public dataset
# metadata; trailing spaces are verbatim from the dataset release)
ADE20K_LABELS: tuple[str, ...] = (
    'wall',
    'building',
    'sky',
    'floor',
    'tree',
    'ceiling',
    'road',
    'bed ',
    'windowpane',
    'grass',
    'cabinet',
    'sidewalk',
    'person',
    'earth',
    'door',
    'table',
    'mountain',
    'plant',
    'curtain',
    'chair',
    'car',
    'water',
    'painting',
    'sofa',
    'shelf',
    'house',
    'sea',
    'mirror',
    'rug',
    'field',
    'armchair',
    'seat',
    'fence',
    'desk',
    'rock',
    'wardrobe',
    'lamp',
    'bathtub',
    'railing',
    'cushion',
    'base',
    'box',
    'column',
    'signboard',
    'chest of drawers',
    'counter',
    'sand',
    'sink',
    'skyscraper',
    'fireplace',
    'refrigerator',
    'grandstand',
    'path',
    'stairs',
    'runway',
    'case',
    'pool table',
    'pillow',
    'screen door',
    'stairway',
    'river',
    'bridge',
    'bookcase',
    'blind',
    'coffee table',
    'toilet',
    'flower',
    'book',
    'hill',
    'bench',
    'countertop',
    'stove',
    'palm',
    'kitchen island',
    'computer',
    'swivel chair',
    'boat',
    'bar',
    'arcade machine',
    'hovel',
    'bus',
    'towel',
    'light',
    'truck',
    'tower',
    'chandelier',
    'awning',
    'streetlight',
    'booth',
    'television receiver',
    'airplane',
    'dirt track',
    'apparel',
    'pole',
    'land',
    'bannister',
    'escalator',
    'ottoman',
    'bottle',
    'buffet',
    'poster',
    'stage',
    'van',
    'ship',
    'fountain',
    'conveyer belt',
    'canopy',
    'washer',
    'plaything',
    'swimming pool',
    'stool',
    'barrel',
    'basket',
    'waterfall',
    'tent',
    'bag',
    'minibike',
    'cradle',
    'oven',
    'ball',
    'food',
    'step',
    'tank',
    'trade name',
    'microwave',
    'pot',
    'animal',
    'bicycle',
    'lake',
    'dishwasher',
    'screen',
    'blanket',
    'sculpture',
    'hood',
    'sconce',
    'vase',
    'traffic light',
    'tray',
    'ashcan',
    'fan',
    'pier',
    'crt screen',
    'plate',
    'monitor',
    'bulletin board',
    'shower',
    'radiator',
    'glass',
    'clock',
    'flag',
)

HUMAN_LABELS: tuple[str, ...] = ("non_person", "person")

label_id_mapping_ade20k = {n: i for i, n in enumerate(ADE20K_LABELS)}
id_label_mapping_ade20k = dict(enumerate(ADE20K_LABELS))
label_id_mapping_human = {n: i for i, n in enumerate(HUMAN_LABELS)}
id_label_mapping_human = dict(enumerate(HUMAN_LABELS))


def get_label_id_mapping(use_human_mask: bool = False) -> dict:
    """Reference mask_utils.get_label_id_mapping."""
    return label_id_mapping_human if use_human_mask else (
        label_id_mapping_ade20k
    )


def get_class_ids_from_labels(labels, use_human_mask: bool = False):
    """Reference mask_utils.get_class_ids_from_labels (ADE20k by default)."""
    mapping = get_label_id_mapping(use_human_mask)
    return [mapping[label] for label in labels]


def mask_from_labels(
    label_map: np.ndarray, labels, use_human_mask: bool = False
) -> np.ndarray:
    """Binary mask selecting the pixels whose semantic id is in ``labels``
    (names or ids). label_map (H, W) int -> (H, W) bool."""
    ids = [
        label if isinstance(label, (int, np.integer))
        else get_label_id_mapping(use_human_mask)[label]
        for label in labels
    ]
    return np.isin(np.asarray(label_map), np.asarray(ids, np.int64))
