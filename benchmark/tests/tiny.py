"""Tiny configurations and traffic of the cells, for the CPU tests: the
published structure at widths a CPU test run can hold."""
from __future__ import annotations

import copy

from benchmark.harness import load_json

SIZE = 64


def tiny_serve_config() -> dict:
    config = copy.deepcopy(load_json("configs", "serve_rmi_mru_resgen768.json"))
    fw = config["framework"]
    fw["matching"].update(H=SIZE, W=SIZE, vf_h=SIZE // 8, vf_w=SIZE // 8,
                          v_emb_dim=16, w_emb_dim=16, m_rnn_size=16,
                          w_rnn_size=16)
    fw["fg_gan"].update(image_size=SIZE, base_channels=8, noise_dim=16)
    fw["bg_gan"].update(image_size=SIZE, ngf=4)
    fw["pipeline"].update(image_size=SIZE, instance_size=SIZE)
    return config


def tiny_train_config() -> dict:
    config = copy.deepcopy(load_json("configs", "train_rmi_deeplabv2.json"))
    config["framework"]["matching"].update(
        H=SIZE, W=SIZE, vf_h=SIZE // 8, vf_w=SIZE // 8, v_emb_dim=16,
        w_emb_dim=16, m_rnn_size=16, w_rnn_size=16)
    return config


def tiny_traffic(name: str, **over) -> dict:
    traffic = copy.deepcopy(load_json("traffic", f"{name}.json"))
    traffic.update(side_px=[40, 14], visits=40, **over)
    if "pool_scenes" in traffic:
        traffic["pool_scenes"] = 8
    return traffic
