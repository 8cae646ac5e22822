// C++ NerfManagerOnline — the API surface the SLAM frontend links against,
// preserved from the reference (ref Core/include/nerf_manager.h:54-91) so a
// Tracking/LocalMapping pipeline drives the JAX runtime exactly the way it
// drove libMON.so. Compute happens in the runtime-server process (JAX/GPU);
// this class is a thin shim over the socket protocol.
//
// Type mapping vs the reference: Eigen::Matrix4f -> monerf::Mat4 (row-major
// float[16]), cv::Mat images -> raw pointers + strides (the OpenCV-based
// frontend passes Mat::data directly).
#pragma once

#include <cstdint>
#include <memory>
#include <string>
#include <vector>

namespace monerf {

class RuntimeClient;

struct Mat4 {
  float m[16];  // row-major
  static Mat4 Identity();
};

struct BoundingBox {
  float min[3];
  float max[3];
};

struct FrameIdAndBbox {  // ref Core/include/common.h FrameIdAndBbox
  uint32_t frame_id;
  uint32_t x, y, h, w;
};

struct MeshData {
  std::vector<float> verts;     // 3 * n_verts
  std::vector<float> normals;   // 3 * n_verts
  std::vector<uint8_t> colors;  // 3 * n_verts
  std::vector<uint32_t> indices;
};

class NerfManagerOnline {
 public:
  // ref NerfManagerOnline(network_config_file, UseSparseDepth,
  //                       TrainStepIterations)
  NerfManagerOnline(const std::string& socket_path, bool use_sparse_depth,
                    int train_step_iterations, int capacity = 16,
                    bool mesh_enabled = true);
  ~NerfManagerOnline();

  bool Init();

  // ref DatasetInit(fx, fy, cx, cy, H, W, imgs)
  void DatasetInit(float fx, float fy, float cx, float cy, int h, int w,
                   std::size_t imgs);

  // ref NewFrameToDataset(imgId, timestamp, img, instance, depth, pose).
  // rgb: H*W*3 u8 (RGB); instance: H*W u8; depth: H*W f32 or nullptr.
  void NewFrameToDataset(unsigned int img_id, const std::string& timestamp,
                         const uint8_t* rgb, const uint8_t* instance,
                         const float* depth, const Mat4& pose_twc);

  // ref UpdateDataset(CurId, FrameNum, Poses)
  void UpdateDataset(unsigned int cur_id, unsigned int frame_num,
                     const std::vector<Mat4>& poses);

  // ref CreateNeRF(Class, ObjTow, BoundingBox) -> object index. If
  // aabb_half is non-null it receives the object's ACTUAL training-volume
  // half-widths (runtime-side inflation included) — the runtime owns the
  // inflation policy, callers must not re-derive it.
  std::size_t CreateNeRF(int cls, const Mat4& obj_tow, const BoundingBox& box,
                         float* aabb_half = nullptr);

  // ref UpdateNeRFBbox(idx, vFrameBbox, train_step)
  void UpdateNeRFBbox(std::size_t idx, const std::vector<FrameIdAndBbox>& boxes,
                      int train_step);

  // Beyond the reference (which freezes SetAttributes at creation, ref
  // nerf.cu:155-176): replace the object's pose + training volume when the
  // SLAM cuboid outgrows the frozen box. The runtime re-inits that slot's
  // field (learned content is tied to the old unit-cube warp) and
  // re-credits the training budget already spent, so the field retrains
  // from the full accumulated supervision. aabb_half as in CreateNeRF.
  void UpdateNeRFVolume(std::size_t idx, const Mat4& obj_tow,
                        const BoundingBox& box, float* aabb_half = nullptr);

  // ref GetFrameIdx(timestamp) — -1 when unknown
  int GetFrameIdx(const std::string& timestamp);

  // ref WaitThreadsEnd()
  bool WaitThreadsEnd();

  // ref RenderNeRFsTest(out_path, Idx, timestamps, vBbox, vTwc, radius).
  // Extras over the reference: per-view bbox crops of the original image
  // (view_rgb: h*w*3 RGB u8, view_mask: h*w object-mask u8, empty vector =
  // absent) let the runtime photometrically refine each held-out view's
  // pose against the trained field before rendering.
  void RenderNeRFsTest(const std::string& out_path, std::size_t idx,
                       const std::vector<std::string>& timestamps,
                       const std::vector<FrameIdAndBbox>& boxes,
                       const std::vector<Mat4>& twcs, float radius,
                       bool video = true,
                       const std::vector<std::vector<uint8_t>>* view_rgb =
                           nullptr,
                       const std::vector<std::vector<uint8_t>>* view_mask =
                           nullptr);

  // Mesh fetch for the viewer (ref DrawMesh draws it; we return the data).
  bool GetMesh(std::size_t idx, MeshData* out);

  // Extras over the reference: explicit pump control + telemetry.
  void StartBackgroundTraining();
  int Pump(int max_waves);  // -1 = drain; returns waves run
  std::vector<float> GetLosses();

 private:
  std::unique_ptr<RuntimeClient> client_;
  bool use_depth_;
  int iters_;
  int capacity_;
  bool mesh_enabled_;
  int h_ = 0, w_ = 0;
};

}  // namespace monerf
