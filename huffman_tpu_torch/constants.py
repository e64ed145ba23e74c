"""Format constants, as in ``huffman_tpu/constants.py``.

The HTP3 (``tpu`` profile) layout stores code lengths up to
``TPU_MAX_CODE_LEN`` in a bitmask; the ``ref`` profile (the reference's
K-stream wire format) caps codes at ``MAX_CODE_LEN`` and pads every
stream region by ``STREAM_SLOP`` bytes.  These numbers fix the bytes of
every blob the port writes.
"""

# Longest canonical code of the ref profile (bits): its header and its
# 2^12-entry decode tables.
MAX_CODE_LEN = 12

# Longest canonical code of the tpu profile (bits).
TPU_MAX_CODE_LEN = 15

# Longest code of the unlimited Huffman build before the length limit:
# enough for any 64-bit total count.
MAX_OPTIMAL_CODE_LEN = 64

# Zero bytes at the low end of every ref-profile stream region.
STREAM_SLOP = 8

# Alphabet size (bytes).
NUM_SYMBOLS = 256
