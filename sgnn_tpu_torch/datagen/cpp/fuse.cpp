// Native TSDF integrate core (ctypes, OpenMP).
//
// The hot loop of the datagen fuser: per-frame voxel projection + TSDF
// running-average update, the C++ counterpart of the reference's
// VoxelGrid::integrate (the reference's datagen/GenerateScans/src/
// VoxelGrid.cpp:7-64). Semantics are bit-for-bit the numpy slab update
// in sgnn_tpu_torch/datagen/fusion.py:_frame_updates (same float32 order
// of operations, round-to-nearest-even pixel rounding); parity is pinned
// by tests/test_torch_datagen.py. Grids are [X, Y, Z] C-order (z
// contiguous).
//
// Built by g++ at first use (fusion.get_fuse_lib, utils/native_build.py)
// into build/fuse-<hash>/ at the repository root.

#include <cmath>
#include <cstdint>
#include <cfenv>

extern "C" {

// lo/hi: inclusive xyz bounds of the frustum slab.
// obb: null or 15 floats (center[3], axes row-major[9], half[3]).
// d01_min/d01_max: the constants of the depth->weight ramp (module
//   DEPTH_MIN/DEPTH_MAX, distinct from the validity range).
void tsdf_integrate(
    float* sdf, float* weight, int32_t* free_ctr,
    int32_t X, int32_t Y, int32_t Z,
    const float* grid2world, const float* world2cam,
    float fx, float fy, float cx, float cy,
    const float* depth, int32_t W, int32_t H,
    float voxel_size, float depth_min, float depth_max,
    float d01_min, float d01_max, float weight_sample,
    const int32_t* lo, const int32_t* hi,
    const float* obb)
{
    (void)X;
    const float g00 = grid2world[0], g01 = grid2world[1],
                g02 = grid2world[2], g03 = grid2world[3];
    const float g10 = grid2world[4], g11 = grid2world[5],
                g12 = grid2world[6], g13 = grid2world[7];
    const float g20 = grid2world[8], g21 = grid2world[9],
                g22 = grid2world[10], g23 = grid2world[11];
    const float c00 = world2cam[0], c01 = world2cam[1],
                c02 = world2cam[2], c03 = world2cam[3];
    const float c10 = world2cam[4], c11 = world2cam[5],
                c12 = world2cam[6], c13 = world2cam[7];
    const float c20 = world2cam[8], c21 = world2cam[9],
                c22 = world2cam[10], c23 = world2cam[11];
    const float ramp_den = d01_max - d01_min;

#pragma omp parallel for schedule(dynamic, 1)
    for (int32_t x = lo[0]; x <= hi[0]; ++x) {
        // numpy round() is round-half-to-even; make nearbyintf match
        std::fesetround(FE_TONEAREST);
        const float xf = (float)x;
        for (int32_t y = lo[1]; y <= hi[1]; ++y) {
            const float yf = (float)y;
            const int64_t row = ((int64_t)x * Y + y) * Z;
            for (int32_t z = lo[2]; z <= hi[2]; ++z) {
                // computed exactly like the numpy einsum (no stepped
                // accumulation: keeps float32 parity)
                const float zf = (float)z;
                const float pwx = g00 * xf + g01 * yf + g02 * zf + g03;
                const float pwy = g10 * xf + g11 * yf + g12 * zf + g13;
                const float pwz = g20 * xf + g21 * yf + g22 * zf + g23;
                const float pcx = c00 * pwx + c01 * pwy + c02 * pwz + c03;
                const float pcy = c10 * pwx + c11 * pwy + c12 * pwz + c13;
                const float pcz = c20 * pwx + c21 * pwy + c22 * pwz + c23;
                const float safe_z = pcz == 0.0f ? 1e-12f : pcz;
                const float uf = nearbyintf(pcx * fx / safe_z + cx);
                const float vf = nearbyintf(pcy * fy / safe_z + cy);
                if (!(uf >= 0.0f && vf >= 0.0f && uf < (float)W &&
                      vf < (float)H))
                    continue;
                const float d = depth[(int32_t)vf * W + (int32_t)uf];
                if (!(std::isfinite(d) && d >= depth_min && d <= depth_max))
                    continue;
                if (obb) {
                    const float rx = (float)x - obb[0];
                    const float ry = (float)y - obb[1];
                    const float rz = (float)z - obb[2];
                    bool in = true;
                    for (int a = 0; a < 3; ++a) {
                        const float p = rx * obb[3 + 3 * a] +
                                        ry * obb[4 + 3 * a] +
                                        rz * obb[5 + 3 * a];
                        if (!(std::fabs(p) <= obb[12 + a] + 1e-6f)) {
                            in = false;
                            break;
                        }
                    }
                    if (!in) continue;
                }
                const int64_t idx = row + z;
                if (pcz < d) free_ctr[idx] += 1;
                const float sdf_new_raw = d - pcz;
                const float trunc = 3.0f * voxel_size + d * voxel_size;
                if (!(sdf_new_raw > -trunc)) continue;
                const float sdf_new =
                    sdf_new_raw > trunc ? trunc : sdf_new_raw;
                const float depth01 = (d - d01_min) / ramp_den;
                float w_upd = weight_sample * 1.5f * (1.0f - depth01);
                if (w_upd < 1.0f) w_upd = 1.0f;
                const float w_old = weight[idx];
                const float s_old = sdf[idx];
                float merged;
                if (!std::isfinite(s_old)) {
                    merged = sdf_new;
                } else {
                    merged = (s_old * w_old + sdf_new * w_upd) /
                             (w_old + w_upd);
                }
                sdf[idx] = merged;
                float w_new = w_old + std::floor(w_upd);
                weight[idx] = w_new > 255.0f ? 255.0f : w_new;
            }
        }
    }
}

}  // extern "C"
