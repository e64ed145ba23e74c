"""Format constants of the ``tpu`` profile (HTP3), as in
``huffman_tpu/constants.py``.

The blob layout stores code lengths up to ``TPU_MAX_CODE_LEN`` in a
bitmask, and every table the port builds is limited to that depth, so
these two numbers fix the bytes of every blob the port writes.
"""

# Longest canonical code of the tpu profile (bits).
TPU_MAX_CODE_LEN = 15

# Alphabet size (bytes).
NUM_SYMBOLS = 256
