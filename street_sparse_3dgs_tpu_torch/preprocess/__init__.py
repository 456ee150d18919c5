from . import (calibration, chunk, colmap_db, colmap_runner, depth_decode,  # noqa: F401
               depth_pipeline, depth_scale, inputs, matchers, mono_depth,
               reorient, virtual_cams)
