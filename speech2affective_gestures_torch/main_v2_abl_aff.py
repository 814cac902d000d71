"""Ablation entry point: no affective (ST-GCN) encoder.

`main_v2` with the same flags and flow, except that the generator takes
the raw seed poses and their constraint bit (pose_dim + 1 features) in
place of the AffEncoder's, and the discriminator is the ConvDiscriminator
(reference net/multimodal_context_net_v2_abl_aff.py:285-439). It trains
in `<base>/models/s2ag_v2_mfcc_torch_abl_aff/<dataset_s2ag>`.

    python -m speech2affective_gestures_torch.main_v2_abl_aff -b BASE_PATH \\
        -c config/multimodal_context_v2.yml --synthetic-data true
"""

from .main_v2 import main as _main


def main(argv=None):
    return _main(argv, variant="abl_aff")


if __name__ == "__main__":
    main()
