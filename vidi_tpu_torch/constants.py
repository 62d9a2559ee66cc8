"""Framework-wide constants.

Mirrors the reference contract (reference: Vidi1.5_9B/vidi/constants.py:9-15):
the `<image>` placeholder token is spliced into text as index -200, ignored
label positions are -100.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

# Gemma2 chat-turn delimiters (reference: Vidi1.5_9B/vidi/dataset/txt_utils.py:85-134)
GEMMA_TURN_USER = "<start_of_turn>user\n"
GEMMA_TURN_MODEL = "<start_of_turn>model\n"
GEMMA_TURN_END = "<end_of_turn>\n"

# Gemma2 end-of-turn token id used as EOS during generation
# (reference: Vidi1.5_9B/vidi/model/lmm/dattn/gemma.py:461-462)
GEMMA_EOS_TOKEN_ID = 107
