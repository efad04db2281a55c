"""Model configs of the port, by the reference's names ("pointnet2-cls")."""

import importlib


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
