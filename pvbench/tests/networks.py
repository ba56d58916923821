"""The published PVNet-8s networks as configuration dicts, for tests:
the committed Resnet18_8s configuration, and Resnet34_8s and
Resnet50_8s described by the same keys (PVNet's
lib/networks/model_repository.py)."""
import json
import os

from pvbench import spec


def config(name: str = "r18_f32") -> dict:
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


R18 = config()
R34 = dict(R18, network="resnet34_8s", stage_sizes=[3, 4, 6, 3])
R50 = dict(R18, network="resnet50_8s", block="Bottleneck",
           stage_sizes=[3, 4, 6, 3], fcdim=384, s8dim=256, s4dim=128,
           s2dim=64, raw_dim=64)
NETWORKS = {"resnet18_8s": R18, "resnet34_8s": R34, "resnet50_8s": R50}
