#!/usr/bin/env python
"""Face2Text preprocessing — the port's counterpart of the root
`preprocess_face2text.py`: CelebA JPEGs + Face2Text caption JSONs +
attribute CSV → face2text-data.h5 + face2text-dicts.json (needs h5py).

    python -m imagecaptioning_tpu_torch.preprocess_face2text \\
        --train_data ... --val_data ... --test_data ... --attr_data ... \\
        --image_dir ... --h5_output data/face2text-data.h5
"""
from imagecaptioning_tpu_torch.data.preprocess_face2text import main

if __name__ == "__main__":
    main()
