"""Model configs of the port, by the reference's names ("pointnet2-cls", "stablelm-1.6b").

The pointnet2 models and the LMs of all six families are ported: dense
(stablelm-1.6b, starcoder2-3b, gemma3-12b, command-r-plus-104b), moe
(granite-moe-3b-a800m, dbrx-132b), ssm (mamba2-1.3b), hybrid
(recurrentgemma-2b), encdec (whisper-small) and vlm (internvl2-2b).
`get_config` raises KeyError for a name with no module here.
"""

import importlib

from repro_torch.configs.base import ARCH_IDS, ModelConfig  # noqa: F401


def get_config(name: str, *, smoke: bool = False):
    """Load `CONFIG` (or `smoke_config()`) from repro_torch.configs.<module>."""
    mod_name = name.replace("-", "_").replace(".", "_")
    try:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    except ModuleNotFoundError as err:
        if err.name != f"repro_torch.configs.{mod_name}":
            raise
        raise KeyError(f"config {name!r} is not ported (no repro_torch.configs.{mod_name})") from err
    return mod.smoke_config() if smoke else mod.CONFIG
