"""Ablation entry point: the raw-waveform audio encoder.

`main_v2` with the same flags and flow, except that the generator takes
the raw 36267-sample audio window through a WavEncoder in place of the
MFCCEncoder (reference net/multimodal_context_net_v2_abl_audio.py), and
the GAN step feeds it the batch's `audio`. It trains in
`<base>/models/s2ag_v2_mfcc_torch_abl_audio/<dataset_s2ag>`.

    python -m speech2affective_gestures_torch.main_v2_abl_audio -b BASE_PATH \\
        -c config/multimodal_context_v2.yml --synthetic-data true
"""

from .main_v2 import main as _main


def main(argv=None):
    return _main(argv, variant="abl_audio")


if __name__ == "__main__":
    main()
