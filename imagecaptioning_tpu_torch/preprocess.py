#!/usr/bin/env python
"""Visual Genome preprocessing — the port's counterpart of the root
`preprocess.py`: JPEGs + region JSON → VG-regions.h5 +
VG-regions-dicts.json (needs h5py).

    python -m imagecaptioning_tpu_torch.preprocess --region_data ... \\
        --image_dir ... --split_json ... --h5_output data/VG-regions.h5
"""
from imagecaptioning_tpu_torch.data.preprocess_vg import main

if __name__ == "__main__":
    main()
