"""Keypoint, epipolar and pose geometry, depth reprojection (impx/geometry)."""
from impx_torch.geometry.keypoints import (
    normalize_keypoints,
    normalize_size,
    normalize_size_spg,
    normalize_intrinsic,
)
from impx_torch.geometry.epipolar import (
    essential_from_pose,
    fundamental_from_essential,
    skew_symmetric,
    epipolar_distance,
    compute_epi_inlier,
    sampson_distance,
)
from impx_torch.geometry.pose import (
    angle_error_mat,
    angle_error_vec,
    compute_pose_error,
    evaluate_R_t,
    pose_auc,
    approx_pose_auc,
    quaternion_from_matrix,
)
from impx_torch.geometry.triangulation import (
    triangulate_points,
    decompose_essential_mat,
    cheirality_mask,
)
from impx_torch.geometry.reprojection import (
    reproject_points,
    match_from_projection_points,
)
