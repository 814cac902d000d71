"""BVH files, stick-figure videos and the pickles of generated clips."""

from . import bvh, video  # noqa: F401
