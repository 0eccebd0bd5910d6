"""OCID dataset class / instance vocabularies (dataset metadata).

Counterpart of crog_tpu/data/ocid_classes.py, copied so that the port
imports nothing of the JAX package.  Stored compactly as name lists; the
dict views (cnames, subnames, sub_to_class) are derived.
"""

from __future__ import annotations

import numpy as np

# 32 object classes, index = position
CLASS_NAMES = [
    "background", "apple", "ball", "banana", "bell_pepper", "binder", "bowl",
    "cereal_box", "coffee_mug", "flashlight", "food_bag", "food_box",
    "food_can", "glue_stick", "hand_towel", "instant_noodles", "keyboard",
    "kleenex", "lemon", "lime", "marker", "orange", "peach", "pear", "potato",
    "shampoo", "soda_can", "sponge", "stapler", "tomato", "toothpaste",
    "unknown",
]

# 67 instance-level names: (class_name, instance suffixes present in OCID)
_INSTANCE_SUFFIXES = {
    "apple": (1, 2), "ball": (1, 2, 3), "banana": (1, 2), "bell_pepper": (1,),
    "binder": (1,), "bowl": (1,), "cereal_box": (1, 3, 4, 5),
    "coffee_mug": (1, 2), "flashlight": (1,), "food_bag": (2, 3, 4),
    "food_box": (1, 2, 3), "food_can": (1, 2, 3), "glue_stick": (1,),
    "hand_towel": (1, 2, 3), "instant_noodles": (1, 2), "keyboard": (1, 2),
    "kleenex": (1, 2, 3), "lemon": (1, 2), "lime": (1, 2), "marker": (1, 2, 3),
    "orange": (1, 2), "peach": (1, 2), "pear": (1, 2), "potato": (1, 2),
    "shampoo": (1, 2, 3), "soda_can": (1, 2), "sponge": (1, 2, 3),
    "stapler": (1, 2), "tomato": (1,), "toothpaste": (1, 2),
}

INSTANCE_NAMES = ["background"]
for _cls in CLASS_NAMES[1:-1]:
    for _i in _INSTANCE_SUFFIXES[_cls]:
        INSTANCE_NAMES.append(f"{_cls}_{_i}")
INSTANCE_NAMES.append("unknown")

# reference-compatible dict views
CNAMES = {name: str(i) for i, name in enumerate(CLASS_NAMES)}
SUBNAMES = {name: i for i, name in enumerate(INSTANCE_NAMES)}
SUB_TO_CLASS = {
    i: (0 if name == "background"
        else CLASS_NAMES.index("unknown") if name == "unknown"
        else CLASS_NAMES.index(name.rsplit("_", 1)[0]))
    for i, name in enumerate(INSTANCE_NAMES)
}

VIS_COLORS = (
    np.array(
        [
            [0.0, 0.0, 1.0], [0.0, 0.5, 0.0], [1.0, 0.0, 0.0],
            [0.0, 0.75, 0.75], [0.75, 0.0, 0.75], [0.75, 0.75, 0.0],
            [1.0, 1.0, 1.0],
        ]
    )
    * 255
)
