"""Open X-Embodiment dataset mixtures: the port's own copy of
``ivideogpt_tpu/data/dataset_mixes.py`` (the mixture-weight tables, which
originate from the Octo project's ``octo/data/oxe/oxe_dataset_mixes.py``,
``resolve_mix`` and ``resolve_eval_dataset_name``), so ``--dataset_name
select`` and the rest resolve to the same training distributions.

The tables are data and stay whole, the Something-Something mixes
(``select_sthsth``, ``sthsth``) included; the loader reads their ``sthsth``
entry with ``data/sthsth_dataset.py`` (``npz_dataset.MixRoboticDataset``).
"""

import os

BRIDGE_MIX = [("bridge", 1.0)]

RT_X_MIX = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 2.0),
    ("berkeley_cable_routing", 3.0),
    ("roboturk", 1.0),
    ("nyu_door_opening_surprising_effectiveness", 5.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 1.0),
    ("toto", 1.0),
]

OXE_FRANKA_MIX = [
    ("taco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("viola", 1.0),
    ("toto", 1.0),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 1.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 3.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("maniskill_dataset_converted_externally_to_rlds", 0.1),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("cmu_franka_exploration_dataset_converted_externally_to_rlds", 5.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("berkeley_rpt_converted_externally_to_rlds", 1.0),
    ("kaist_nonprehensile_converted_externally_to_rlds", 3.0),
    ("stanford_robocook_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("cmu_play_fusion", 1.0),
]

OXE_MAGIC_SOUP = [
    ("fractal20220817_data", 0.54087122203),
    ("kuka", 0.8341046294),
    ("bridge", 1.0),
    ("taco_play", 2.0),
    ("jaco_play", 1.0),
    ("berkeley_cable_routing", 1.0),
    ("roboturk", 2.0),
    ("nyu_door_opening_surprising_effectiveness", 1.0),
    ("viola", 2.0),
    ("berkeley_autolab_ur5", 2.0),
    ("toto", 1.0),
    ("language_table", 0.1),
    ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
    ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
    ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
    ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
    ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
    ("bc_z", 0.2),
    ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
    ("utaustin_mutex", 1.0),
    ("berkeley_fanuc_manipulation", 2.0),
    ("cmu_stretch", 1.0),
]

_SELECT_CORE = [
    ("fractal20220817_data", 0.15),
    ("kuka", 0.1),
    ("bridge", 0.15),
    ("bc_z", 0.15),
    ("robo_net", 0.15),
    ("language_table", 0.05),
    ("stanford_mask_vit_converted_externally_to_rlds", 0.05),
]

_SELECT_SMALL_NAMES = [
    "taco_play", "jaco_play", "roboturk", "viola", "toto",
    "columbia_cairlab_pusht_real",
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds",
    "stanford_hydra_dataset_converted_externally_to_rlds",
    "austin_buds_dataset_converted_externally_to_rlds",
    "nyu_franka_play_dataset_converted_externally_to_rlds",
    "furniture_bench_dataset_converted_externally_to_rlds",
    "ucsd_kitchen_dataset_converted_externally_to_rlds",
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds",
    "austin_sailor_dataset_converted_externally_to_rlds",
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds",
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds",
    "utokyo_xarm_bimanual_converted_externally_to_rlds",
    "kaist_nonprehensile_converted_externally_to_rlds",
    "dlr_sara_pour_converted_externally_to_rlds",
    "dlr_sara_grid_clamp_converted_externally_to_rlds",
    "dlr_edan_shared_control_converted_externally_to_rlds",
    "asu_table_top_converted_externally_to_rlds",
    "uiuc_d3field1", "uiuc_d3field2", "uiuc_d3field3", "uiuc_d3field4",
    "utaustin_mutex", "berkeley_fanuc_manipulation",
    "cmu_playing_with_food", "cmu_play_fusion", "cmu_stretch",
]

# core 0.80 total + 0.20 spread uniformly over the long tail
# (reference dataset_mixes.py:186)
OXE_SELECT = _SELECT_CORE + [
    (name, 0.20 / len(_SELECT_SMALL_NAMES)) for name in _SELECT_SMALL_NAMES]

OXE_SELECT_STHSTH = [(n, w * 0.85) for n, w in OXE_SELECT] + [("sthsth", 0.15)]

def resolve_mix(name: str, parent_dir: str = None):
    """Mix for ``--dataset_name``: a registered named mix, or — for custom
    data — any name that exists as an episode directory under
    ``parent_dir`` becomes a single-source mix ``[(name, 1.0)]`` (the
    reference hard-errors on unregistered names; a custom-corpus user
    should not have to edit a weights table to train on one directory)."""
    if name in DATASET_NAMED_MIXES:
        return DATASET_NAMED_MIXES[name]
    if parent_dir and os.path.isdir(os.path.join(parent_dir, name)):
        return [(name, 1.0)]
    raise KeyError(
        f"dataset_name {name!r} is neither a registered mix "
        f"({', '.join(sorted(DATASET_NAMED_MIXES))}) nor a directory under "
        f"{parent_dir!r}")


def resolve_eval_dataset_name(name: str) -> str:
    """Resolve a single-dataset mix alias to its underlying eval dataset
    (e.g. ``"bair"`` -> ``"bair_robot_pushing"``); multi-dataset mixes and
    plain dataset names pass through unchanged."""
    if name in DATASET_NAMED_MIXES and len(DATASET_NAMED_MIXES[name]) == 1:
        return DATASET_NAMED_MIXES[name][0][0]
    return name


DATASET_NAMED_MIXES = {
    "frac": [("fractal20220817_data", 1.0)],
    "robonet": [("robo_net", 1.0)],
    "tfds_robonet": [("tfds_robonet", 1.0)],
    "bair": [("bair_robot_pushing", 1.0)],
    "vp2_robodesk": [("vp2_robodesk", 1.0)],
    "vp2_robosuite": [("vp2_robosuite", 1.0)],
    "select": OXE_SELECT,
    "select_sthsth": OXE_SELECT_STHSTH,
    "sthsth": [("sthsth", 1.0)],
    "rtx": RT_X_MIX,
    "rtx_franka": RT_X_MIX + OXE_FRANKA_MIX,
    "oxe_magic_soup": OXE_MAGIC_SOUP,
    "debug": [("cmu_stretch", 1.0)],
}
