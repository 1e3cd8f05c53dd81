"""Config assembly: CLI args + ``DATAX_*`` env vars + ``.conf`` file.

reference: datax-host ConfigManager.scala:18-136, utility/ArgumentsParser

Copy of the JAX package's ``core/confmanager.py``. Trimmed: an
``objstore://`` conf path needs the object-store client
(``serve/objectstore.py``), which is not ported, so it raises.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Sequence

from ..constants import JobArgument
from .config import (
    EngineException,
    SettingDictionary,
    parse_conf_lines,
)


def get_named_args(args: Sequence[str]) -> Dict[str, str]:
    """Parse ``key=value`` CLI arguments (reference: ArgumentsParser.scala)."""
    named: Dict[str, str] = {}
    for a in args:
        pos = a.find("=")
        if pos > 0:
            named[a[:pos].strip()] = a[pos + 1:].strip()
    return named


class ConfigManager:
    """Process-wide configuration singleton.

    reference: ConfigManager.scala:18-81 (double-checked-locking singleton)
    """

    _lock = threading.Lock()
    _active: Optional[SettingDictionary] = None

    @classmethod
    def _local_env_vars(cls) -> Dict[str, str]:
        prefix = JobArgument.ConfNamePrefix
        return {k: v for k, v in os.environ.items() if k.startswith(prefix)}

    @classmethod
    def get_active_dictionary(cls) -> SettingDictionary:
        if cls._active is None:
            with cls._lock:
                if cls._active is None:
                    cls._active = SettingDictionary(cls._local_env_vars())
        return cls._active

    @classmethod
    def set_active_dictionary(cls, conf: SettingDictionary) -> None:
        with cls._lock:
            cls._active = conf

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._active = None

    @classmethod
    def get_configuration_from_arguments(
        cls, args: Sequence[str]
    ) -> SettingDictionary:
        """Merge env + CLI into the active dictionary.

        reference: ConfigManager.scala:61-81
        """
        named = get_named_args(args)
        if "conf" not in named:
            raise EngineException("configuration file is not specified.")
        envs = cls._local_env_vars()
        converted = {
            JobArgument.ConfName_AppConf: named.get("conf"),
            JobArgument.ConfName_LogLevel: named.get("executorLogLevel"),
            JobArgument.ConfName_CheckpointEnabled: named.get("checkpointEnabled"),
        }
        converted = {k: v for k, v in converted.items() if v is not None}
        merged = {**envs, **named, **converted}
        conf = SettingDictionary(merged)
        cls.set_active_dictionary(conf)
        return conf

    @classmethod
    def load_config(cls, conf_file: Optional[str] = None) -> SettingDictionary:
        """Read the flat ``.conf`` file and merge into the active dictionary.

        ``${token}`` placeholders in values are substituted from the already
        merged dictionary (reference: ConfigManager.scala:117-126).
        """
        d = cls.get_active_dictionary()
        path = conf_file or d.get_app_configuration_file()
        if path is None:
            raise EngineException("No conf file is provided")
        if not path.lower().endswith(".conf"):
            raise EngineException(
                "non-conf file is not supported as configuration input"
            )
        if path.startswith(("objstore://", "objstore+https://")):
            raise EngineException(
                f"cannot read {path!r}: the objstore:// client is not "
                "ported yet"
            )
        with open(path, "r", encoding="utf-8") as f:
            props = parse_conf_lines(f.readlines(), d.dict)
        merged = d.with_settings(props)
        cls.set_active_dictionary(merged)
        return merged
