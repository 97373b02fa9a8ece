from .config import NoneDict, dict_to_nonedict, parse, parse_dict, read_json, read_yaml
from .defaults import get_network_G_config, get_network_defaults

__all__ = ["NoneDict", "dict_to_nonedict", "parse", "parse_dict",
           "read_json", "read_yaml", "get_network_G_config",
           "get_network_defaults"]
