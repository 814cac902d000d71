"""Dataset/skeleton constants of the TED Gesture DB pipeline.

Semantics from reference `utils/ted_db_utils.py:12-19` (skeleton topology and
bone lengths) and `config/multimodal_context_v2.yml:19-20` (dataset statistics
baked into the model config).  These are *facts about the dataset*, not code.
"""

from __future__ import annotations

import numpy as np

# --- skeleton topology (TED upper-body, 10 joints / 9 bones) ---------------
# (parent_joint, child_joint, bone_length); ref utils/ted_db_utils.py:14-15
DIR_VEC_PAIRS: tuple[tuple[int, int, float], ...] = (
    (0, 1, 0.26),
    (1, 2, 0.18),
    (2, 3, 0.14),
    (1, 4, 0.22),
    (4, 5, 0.36),
    (5, 6, 0.33),
    (1, 7, 0.22),
    (7, 8, 0.36),
    (8, 9, 0.33),
)

NUM_JOINTS = 10
NUM_BONES = len(DIR_VEC_PAIRS)  # 9
COORDS = 3
POSE_DIM = NUM_BONES * COORDS  # 27

# bone-graph edges (indices into DIR_VEC_PAIRS); ref utils/ted_db_utils.py:16
DIR_EDGE_PAIRS: tuple[tuple[int, int], ...] = (
    (0, 1), (1, 2), (0, 3), (3, 4), (4, 5), (0, 6), (6, 7), (7, 8),
)

# grouping of bones into 3 body parts (spine+head, left arm, right arm);
# ref utils/ted_db_utils.py:17-19
BODY_PARTS_EDGE_IDX: tuple[tuple[int, ...], ...] = (
    (0, 1, 2), (3, 4, 5), (6, 7, 8),
)
MAX_BODY_PART_EDGES = 3
BODY_PARTS_EDGE_PAIRS: tuple[tuple[int, int], ...] = ((0, 1), (0, 2))

# display colours for the renderer; ref utils/ted_db_utils.py:12-13
SKELETON_LINE_PAIRS = (
    (0, 1, "b"), (1, 2, "darkred"), (2, 3, "r"), (3, 4, "orange"),
    (1, 5, "darkgreen"), (5, 6, "limegreen"), (6, 7, "darkseagreen"),
)

# --- audio / sequence geometry ---------------------------------------------
AUDIO_SR = 16000           # main_v2.py:121
FPS = 15                   # config/multimodal_context_v2.yml:42
N_POSES = 34               # config/multimodal_context_v2.yml:43
N_PRE_POSES = 4            # config/multimodal_context_v2.yml:44
SUBDIVISION_STRIDE = 10    # config/multimodal_context_v2.yml:45
NUM_MFCC = 14              # config/multimodal_context_v2.yml:15

# loader_v2.py:480-484 derived geometry
EXPECTED_AUDIO_LENGTH = int(round(N_POSES / FPS * AUDIO_SR))        # 36267
NUM_MFCC_COMBINED = NUM_MFCC * 3 - 5                                 # 37
MFCC_LENGTH = int(np.ceil(EXPECTED_AUDIO_LENGTH / 512))              # 71
# NOTE: processor_v2.py:124 computes int(np.ceil(audio_length / 512)) = 71,
# while loader_v2.py:484 computes int(np.ceil(audio_length) / 512) = 70.
# The *model* is built with the processor's value via mfcc_length; the
# stored features are truncated to mfcc_length at batch time
# (processor_v2.py:691). We follow the processor (71) as model input width.
MFCC_LENGTH_LOADER = int(np.ceil(EXPECTED_AUDIO_LENGTH) // 512)      # 70

# --- dataset statistics (config/multimodal_context_v2.yml:19-20) ------------
MEAN_DIR_VEC = np.array([
    0.0154009, -0.9690125, -0.0884354, -0.0022264, -0.8655276, 0.4342174,
    -0.0035145, -0.8755367, -0.4121039, -0.9236511, 0.3061306, -0.0012415,
    -0.5155854, 0.8129665, 0.0871897, 0.2348464, 0.1846561, 0.8091402,
    0.9271948, 0.2960011, -0.013189, 0.5233978, 0.8092403, 0.0725451,
    -0.2037076, 0.1924306, 0.8196916,
], dtype=np.float32)

MEAN_POSE = np.array([
    0.0000306, 0.0004946, 0.0008437, 0.0033759, -0.2051629, -0.0143453,
    0.0031566, -0.3054764, 0.0411491, 0.0029072, -0.4254303, -0.001311,
    -0.1458413, -0.1505532, -0.0138192, -0.2835603, 0.0670333, 0.0107002,
    -0.2280813, 0.112117, 0.2087789, 0.1523502, -0.1521499, -0.0161503,
    0.291909, 0.0644232, 0.0040145, 0.2452035, 0.1115339, 0.2051307,
], dtype=np.float32)
