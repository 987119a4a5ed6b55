from .index import (  # noqa: F401
    SEQType,
    beat2index,
    find_beat,
    idxenc2npenc,
    npenc2idxenc,
    position_enc,
    seq_prefix,
    sort_instruments,
)
from .encode import chordarr2npenc, notes2chordarr  # noqa: F401
from .decode import npenc2chordarr, npenc_len       # noqa: F401
from .item import MusicItem, MultitrackItem         # noqa: F401
