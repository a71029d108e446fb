"""Native (C++) host code — port of the JAX package's `native/`.

`fastloader.cpp`: a multi-threaded batch gather (and the cropped image
gather) over RAM-cached record arrays, the host half of the input
pipeline, compiled with g++ at first use (`build.library`).
"""

from imagecaptioning_tpu_torch.native.build import (  # noqa: F401
    gather_images_cropped, gather_images_cropped_reference, gather_records,
    gather_records_reference)
