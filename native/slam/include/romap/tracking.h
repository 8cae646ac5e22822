// Monocular tracking + object pipeline — the rebuilt equivalent of the
// reference's Tracking/LocalMapping pair (ref src/Tracking.cc:309-2537,
// src/LocalMapping.cc:58-1292), single-threaded by design: the expensive
// async half (NeRF training) already lives in the JAX runtime process, so
// the frontend stays a simple deterministic loop.
//
// Per frame: ORB -> motion-model pose (PnP) -> local-map tracking ->
// object pipeline (detection filtering, map-point binding, association,
// landmark update) -> keyframe decision -> mapping step (triangulation,
// culling, object merge/cull, NeRF triggering).
#pragma once

#include <condition_variable>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <optional>
#include <set>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>

#include "romap/bow.h"
#include "romap/features.h"
#include "romap/frame.h"
#include "romap/loop_closing.h"
#include "romap/map.h"
#include "romap/object_map.h"

namespace romap {

struct TrackingConfig {
  CameraModel cam;
  int n_features = 1200;
  // detection filtering (ref src/Tracking.cc:393-469)
  std::set<int> ignore_classes;
  float min_box_area_ratio = 0.005f;
  float max_box_area_ratio = 0.5f;
  float mutual_iou_filter = 0.4f;
  int edge_margin = 20;
  // object lifecycle
  int init_after_frames = 3;       // ref Tracking.cc:1354 (frame > init+3)
  int min_points_new_object = 10;  // min points to spawn a landmark
  int min_continue_obs = 3;        // ref Minimum.continue.obs
  ObjectConfig object;
  // keyframe policy
  int max_frames_between_kf = 10;
  float kf_tracked_ratio = 0.8f;
  // Post-relocalization strict-inlier window, in frames. The reference
  // gates on mMaxFrames = camera fps (ref src/Tracking.cc:1822, typically
  // 30): for this many frames after a relocalization a pose needs >= 50
  // inliers (vs 30 normally) before it is trusted.
  int reloc_strict_frames = 30;
  // NeRF triggering (ref LocalMapping.cc:1199-1266): create when the
  // camera-object viewing angle changed by > 2*angle_change since creation
  // observation and >= min_bboxes_for_nerf keyframe boxes pend; push
  // incremental batches at > angle_change.
  float nerf_angle_change = 0.25f;  // radians
  int min_bboxes_for_nerf = 10;
  // Loop closing (Sim3 + essential graph, romap/loop_closing.h). Default
  // OFF = reference behavioral parity: the reference ships LoopClosing.cc
  // but starves it by disabling keyframe insertion
  // (ref src/LocalMapping.cc:100-101).
  bool enable_loop_closing = false;
  LoopClosingConfig loop;
  // Async-mapping backpressure: when the mapping thread falls more than
  // this many keyframes behind (queued + in flight), Track() blocks until
  // it catches up. The reference instead throttles at the source — KF
  // creation requires an idle LocalMapping or queue<3 (ref
  // src/Tracking.cc:1854-1905) — which keeps real time by dropping
  // supervision; blocking keeps every keyframe and makes results
  // independent of host speed (on a 1-core box an unbounded queue let
  // tracking run whole local-BA windows ahead of the map). <0 = unbounded.
  int max_kf_behind = 2;
};

// Detection input per frame (from YOLO files / instance masks).
struct Detection {
  cv::Rect_<float> rect;
  int cls = 0;
  float confidence = 1.0f;
};

// Callbacks into the NeRF runtime (wired to monerf::NerfManagerOnline by the
// System; null-able so SLAM runs standalone).
struct NerfHooks {
  // Fires AFTER local BA refines the keyframe pose (ref LocalMapping.cc:
  // 74-105 uploads post-BA), so the NeRF frame store never trains on a
  // pre-BA pose.
  std::function<void(const KeyFrame&, const cv::Mat& rgb,
                     const cv::Mat& instance, const cv::Mat& sparse_depth)>
      on_keyframe;
  std::function<int(ObjectMap*)> create_nerf;  // returns nerf index
  std::function<void(ObjectMap*, const std::vector<std::array<int64_t, 5>>&)>
      update_bboxes;  // rows: frame_idx, x, y, h, w
  // Refined (timestamp, Twc) for every keyframe in the local-BA window —
  // lets the runtime rewrite already-uploaded poses (ref UpdateDataset
  // nerf_manager.cu:220-235 / nerf_data.cu:341-353).
  std::function<void(const std::vector<std::pair<double, SE3>>&)> update_poses;
  // Fired (from the mapping step) when a NeRF'd object's live cuboid probe
  // outgrows its frozen shape: the client decides whether the probe still
  // fits the runtime's training volume and, if not, pushes a volume update
  // (field re-init). Return true to ADOPT the probe as the object's shape
  // (keeps SLAM state and the runtime volume in lockstep); false keeps the
  // frozen shape. Beyond the reference (which freezes SetAttributes at
  // creation, ref nerf.cu:155-176).
  std::function<bool(ObjectMap*, const Cuboid&)> update_volume;
  // Fired by the early-loss map reset (ref Tracking.cc:728-737): every
  // ObjectMap*/KeyFrame* the client holds is invalid afterwards.
  std::function<void()> on_reset;
  // Fires at the end of every successfully tracked frame (tracking thread,
  // outside the map lock). obs: (object, this frame's detection bbox) for
  // every object observed in the frame. was_keyframe: the frame was also
  // selected as a keyframe — its image will arrive via on_keyframe with a
  // post-BA pose, so dense-view uploaders must skip it to avoid a stale
  // duplicate. Beyond the reference (which trains on keyframes only): lets
  // the app ship every tracked view as NeRF supervision.
  std::function<void(double timestamp, const SE3& tcw, const cv::Mat& rgb,
                     const cv::Mat& instance,
                     const std::vector<std::pair<ObjectMap*, Bbox>>& obs,
                     bool was_keyframe)>
      on_frame;
};

class Tracker {
 public:
  explicit Tracker(const TrackingConfig& cfg);
  ~Tracker() { StopMapping(); }

  // Process one frame. rgb: BGR or RGB u8 (used for ORB via gray),
  // instance: u8 mask (may be empty), detections: filtered externally or raw.
  // Returns the camera pose when tracking succeeded.
  std::optional<SE3> Track(const cv::Mat& gray, const cv::Mat& instance,
                           const std::vector<Detection>& detections,
                           double timestamp, const cv::Mat& rgb = {});

  enum class State { kNotInitialized, kOk, kLost };
  State state() const { return state_; }
  Map& map() { return map_; }
  const Frame& current() const { return cur_; }
  NerfHooks hooks;

  // trajectory of every tracked frame (TUM export). Each entry also keeps
  // the reference keyframe at tracking time plus the frame's pose RELATIVE
  // to it (tcw = t_cr * ref_kf->tcw) — ORB-SLAM's trajectory bookkeeping
  // (ref src/Tracking.cc mlRelativeFramePoses/mlpReferences + System::
  // SaveTrajectoryTUM src/System.cc:412-443): when BA later refines the
  // keyframes, every frame pose recomposes consistently. Culled keyframes
  // stay allocated (Map::EraseKeyFrame), so ref_kf stays valid; a map
  // Reset() nulls ref_kf on prior entries (their keyframes are freed).
  struct Stamped {
    double t;
    SE3 tcw;
    KeyFrame* ref_kf = nullptr;
    SE3 t_cr;
  };
  const std::vector<Stamped>& trajectory() const { return trajectory_; }

  // Consistent copy of everything exporters/viewers read, taken under
  // map_mutex_ in async mode — the mapping thread mutates keyframe poses,
  // point positions (BA) and object shapes under the same lock, so reading
  // the live Map mid-run without it is a data race.
  struct MapSnapshot {
    // per-frame poses recomposed from the CURRENT (BA-refined) reference-
    // keyframe poses — SaveTrajectoryTUM semantics, see Stamped
    std::vector<Stamped> trajectory;
    struct KF {
      double t;
      SE3 tcw;
    };
    std::vector<KF> keyframes;
    std::vector<Vec3> points;
    struct Obj {
      long id;
      int cls;
      SE3 t_obj_w;
      float a1, a2, a3;
    };
    std::vector<Obj> objects;
  };
  MapSnapshot Snapshot();

  void FinalizeObjects();  // final EIF + shape pass (ref LocalMapping.cc:135-146)
  // Full-window BA over every keyframe + pose rewrite to the NeRF store
  // (update_poses hook). Beyond the reference (its GBA lives in the starved
  // LoopClosing thread and never runs); call between StopMapping() and
  // FinalizeObjects().
  void FinalBundleAdjust();

  // Run the mapping step (triangulation/BA/merges/NeRF feed) on a dedicated
  // thread with a keyframe queue — the reference's LocalMapping thread
  // (ref src/System.cc:84-96, producer-consumer queue LocalMapping.h:
  // 104-110). Tracking then never blocks on BA or on shipping keyframe
  // images to the NeRF runtime.
  void StartMapping();
  void StopMapping();  // drain the queue, then join

  // --- timing telemetry (ref examples/Monocular/mono_tum.cc:85-122 prints
  // median/mean tracking times; src/LocalMapping.cc:160-169 mapping) ---
  size_t QueueDepth();  // pending keyframes = how far mapping lags tracking
  std::vector<double> mapping_ms();  // per-MappingStep wall times
  // mean object-pipeline (association) time per tracked frame, µs — the
  // reference prints this at shutdown (ref src/System.cc:329-334)
  double mean_association_us() const {
    return assoc_frames_ ? assoc_us_total_ / assoc_frames_ : 0.0;
  }
  long loops_closed() const { return loops_closed_; }
  // per-stage tracking split (µs totals over `frames` Track calls):
  // build = ORB + LSD + frame assembly; match = pose tracking (motion
  // model / ref-KF / reloc + local map); objects = association pipeline;
  // keyframe = creation + (sync-mode) mapping step. Beyond the
  // reference's single tracking median — pinpoints WHERE a frame budget
  // went when the real-time factor slips.
  struct StageSplit {
    double build = 0, match = 0, objects = 0, keyframe = 0, wait = 0;
    long frames = 0;
  };
  StageSplit stage_split() const { return stages_; }

 private:
  Stamped MakeStamped(double timestamp) const;
  void BuildFrame(const cv::Mat& gray, const cv::Mat& instance,
                  const std::vector<Detection>& detections, double timestamp);
  std::vector<Detection> FilterDetections(const std::vector<Detection>& in) const;
  bool Initialize();
  bool TrackWithMotionModel();
  bool TrackReferenceKeyFrame();  // fallback (ref Tracking.cc:566-600)
  bool Relocalize();              // recovery from kLost (ref :566-623)
  void Reset();                   // early-loss map reset (ref :728-737)
  bool TrackLocalMap();
  void ObjectPipeline(const cv::Mat& instance);
  bool NeedKeyFrame() const;
  KeyFrame* MakeKeyFrame(const cv::Mat& rgb, const cv::Mat& instance);
  void MappingStep(KeyFrame* kf, const cv::Mat& rgb, const cv::Mat& instance,
                   const Lines& lines);  // BA/upload/cull/merge/NeRF
  void MappingLoop();
  void TriggerNerf(KeyFrame* kf);
  cv::Mat SparseDepth(const KeyFrame& kf) const;

  TrackingConfig cfg_;
  OrbExtractor orb_;
  Map map_;
  State state_ = State::kNotInitialized;

  // place recognition (BoW-lite; the reference's DBoW2 + KeyFrameDatabase
  // role, ref src/KeyFrameDatabase.cc, src/System.cc:53-66)
  BowVocabulary voc_;
  KeyFrameDatabase kfdb_{&voc_};
  std::unique_ptr<LoopCloser> loop_closer_;  // when cfg_.enable_loop_closing
  long loops_closed_ = 0;

  Frame cur_, last_;
  Frame init_ref_;
  bool has_init_ref_ = false;
  SE3 velocity_;
  bool has_velocity_ = false;
  KeyFrame* last_kf_ = nullptr;
  long frames_since_kf_ = 0;
  long init_frame_id_ = 0;
  std::vector<Stamped> trajectory_;
  // young map points under culling observation (point, created-at kf id)
  std::vector<std::pair<MapPoint*, long>> recent_points_;

  // --- async mapping state ---
  struct PendingKF {
    KeyFrame* kf;
    cv::Mat rgb, instance;
    Lines lines;
  };
  bool mapping_async_ = false;
  std::thread mapping_thread_;
  std::mutex map_mutex_;  // guards the Map between tracking + mapping
  std::mutex queue_mutex_;
  std::condition_variable queue_cv_;
  std::condition_variable queue_drain_cv_;  // signaled when a KF finishes
  std::deque<PendingKF> kf_queue_;
  int mapping_in_flight_ = 0;  // popped but still processing (queue_mutex_)
  bool mapping_finish_ = false;
  std::vector<double> mapping_ms_;  // guarded by queue_mutex_
  double assoc_us_total_ = 0.0;  // tracking thread only
  long assoc_frames_ = 0;
  long last_reloc_frame_ = -1000;  // frame id of the last relocalization
  StageSplit stages_;  // tracking thread only

  // per-object creation-time viewing direction (for the angle trigger)
  std::map<ObjectMap*, Vec3, ById> first_view_dir_;
  std::map<ObjectMap*, Vec3, ById> last_pushed_dir_;
};

}  // namespace romap
