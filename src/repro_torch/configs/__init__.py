"""Model and workload configurations: the ten LM architectures of the
assigned pool and the paper's own ``lumina-3dgs``.

``get_config(name)`` resolves any of them; ``ALL_LM_ARCHS`` lists the ten
LM architectures.  The LM configs are data only, one file each.
"""
from __future__ import annotations

import importlib

ALL_LM_ARCHS = (
    'yi-34b', 'command-r-35b', 'smollm-360m', 'nemotron-4-15b',
    'granite-moe-1b-a400m', 'llama4-maverick-400b-a17b', 'whisper-base',
    'chameleon-34b', 'xlstm-1.3b', 'zamba2-1.2b',
)

_MODULES = {
    'yi-34b': 'yi_34b',
    'command-r-35b': 'command_r_35b',
    'smollm-360m': 'smollm_360m',
    'nemotron-4-15b': 'nemotron_4_15b',
    'granite-moe-1b-a400m': 'granite_moe_1b_a400m',
    'llama4-maverick-400b-a17b': 'llama4_maverick_400b_a17b',
    'whisper-base': 'whisper_base',
    'chameleon-34b': 'chameleon_34b',
    'xlstm-1.3b': 'xlstm_1_3b',
    'zamba2-1.2b': 'zamba2_1_2b',
    'lumina-3dgs': 'lumina_3dgs',
}


def get_config(name: str):
    mod = importlib.import_module(f'{__name__}.{_MODULES[name]}')
    return mod.CONFIG
