"""The dataset tables the inference path reads: the port's own copy of
``BASE_STEPSIZE``, ``DISPLAY_KEY``, ``get_base_stepsize`` and
``get_display_key`` (``ivideogpt_tpu/data/npz_dataset.py:34-112``). The
training loaders are not ported.
"""

from __future__ import annotations

# Per-dataset native control-frequency stepsize (reference
# simple_dataloader.py:18-70).
BASE_STEPSIZE = {
    "fractal20220817_data": 3,
    "kuka": 10,
    "bridge": 5,
    "taco_play": 15,
    "jaco_play": 10,
    "berkeley_cable_routing": 10,
    "roboturk": 10,
    "viola": 20,
    "toto": 30,
    "language_table": 10,
    "columbia_cairlab_pusht_real": 10,
    "stanford_kuka_multimodal_dataset_converted_externally_to_rlds": 20,
    "stanford_hydra_dataset_converted_externally_to_rlds": 10,
    "austin_buds_dataset_converted_externally_to_rlds": 20,
    "nyu_franka_play_dataset_converted_externally_to_rlds": 3,
    "maniskill_dataset_converted_externally_to_rlds": 20,
    "furniture_bench_dataset_converted_externally_to_rlds": 10,
    "ucsd_kitchen_dataset_converted_externally_to_rlds": 2,
    "ucsd_pick_and_place_dataset_converted_externally_to_rlds": 3,
    "austin_sailor_dataset_converted_externally_to_rlds": 20,
    "bc_z": 10,
    "utokyo_pr2_opening_fridge_converted_externally_to_rlds": 10,
    "utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds": 10,
    "utokyo_xarm_pick_and_place_converted_externally_to_rlds": 10,
    "utokyo_xarm_bimanual_converted_externally_to_rlds": 10,
    "robo_net": 1,
    "kaist_nonprehensile_converted_externally_to_rlds": 10,
    "stanford_mask_vit_converted_externally_to_rlds": 1,
    "dlr_sara_pour_converted_externally_to_rlds": 10,
    "dlr_sara_grid_clamp_converted_externally_to_rlds": 10,
    "dlr_edan_shared_control_converted_externally_to_rlds": 5,
    "asu_table_top_converted_externally_to_rlds": 12.5,
    "iamlab_cmu_pickup_insert_converted_externally_to_rlds": 20,
    "uiuc_d3field1": 1,
    "uiuc_d3field2": 1,
    "uiuc_d3field3": 1,
    "uiuc_d3field4": 1,
    "utaustin_mutex": 20,
    "berkeley_fanuc_manipulation": 10,
    "cmu_playing_with_food": 10,
    "cmu_play_fusion": 5,
    "cmu_stretch": 10,
    # downstream tasks
    "bair_robot_pushing": 1,
    "vp2_robodesk": 1,
    "vp2_robosuite": 1,
}

# Per-dataset camera key inside each npz (reference simple_dataloader.py:73-98).
DISPLAY_KEY = {
    "taco_play": "rgb_static",
    "roboturk": "front_rgb",
    "viola": "agentview_rgb",
    "berkeley_autolab_ur5": "hand_image",
    "language_table": "rgb",
    "berkeley_mvp_converted_externally_to_rlds": "hand_image",
    "berkeley_rpt_converted_externally_to_rlds": "hand_image",
    "stanford_robocook_converted_externally_to_rlds1": "image_1",
    "stanford_robocook_converted_externally_to_rlds2": "image_2",
    "stanford_robocook_converted_externally_to_rlds3": "image_3",
    "stanford_robocook_converted_externally_to_rlds4": "image_4",
    "uiuc_d3field1": "image_1",
    "uiuc_d3field2": "image_2",
    "uiuc_d3field3": "image_3",
    "uiuc_d3field4": "image_4",
    "bair_robot_pushing": "aux1_image",
    "vp2_robodesk": "image",
    "vp2_robosuite": "image",
}


def get_base_stepsize(name: str) -> float:
    return BASE_STEPSIZE.get(name, 1)


def get_display_key(name: str) -> str:
    return DISPLAY_KEY.get(name, "image")
