"""Version constants.

Archive format version kept at 3.0 for cross-compatibility with the
reference tool (reference: src/common/defs.h:28-29).
"""

AGC_FILE_MAJOR = 3
AGC_FILE_MINOR = 0

PRODUCER = "agc-tpu"
PRODUCER_VERSION = (0, 1, 0)
PRODUCER_VERSION_STR = ".".join(map(str, PRODUCER_VERSION))
PRODUCER_BUILD = "20260816.1"

COMMENT = (
    f"AGC-TPU (TPU-native Assembled Genomes Compressor) v. {PRODUCER_VERSION_STR}"
    f" [build {PRODUCER_BUILD}]"
)
