"""Host-side data: edit records, pipeline fixtures, the matching training
set, the FG GAN's record shards and the BG GAN's dataset.  Copies of the
JAX package's ``data/records.py``, ``data/fixtures.py``,
``data/matching_dataset.py``, ``data/im_ops.py``, ``data/fg_records.py`` and
``data/bg_dataset.py``."""
from .records import fetch_records, update_records, withdraw_records
from .fixtures import (
    load_sketch_image,
    load_inner_mask,
    load_color_map,
    load_seg_data,
    expand_small_segmentation_mask,
    compute_mask_iou,
    compute_mask_occupied_percentage,
    get_pred_instance_mask,
)
from .matching_dataset import (
    load_data_gt, load_mask, load_mask_simp, extract_bboxes,
    build_train_info, MatchingTrainDataset,
)
from .im_ops import resize_and_pad, resize_and_crop, bboxes_from_masks
from .fg_records import (
    write_record_shard, read_record_shard, preprocess_pair, FGPairedDataset,
)
from .bg_dataset import BGDataset, load_region_mask
