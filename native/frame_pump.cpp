// frame_pump: multi-threaded native frame loader + preprocessor.
//
// Counterpart of the reference's C++ producer + threading runtime
// (src/openpose/producer/*, include/openpose/thread/threadManager.hpp): a
// worker pool decodes images (file or in-memory JPEG), applies the
// aspect-preserving resize (resizeFixedAspectRatio,
// src/openpose/utilities/openCvPrivate.cpp:34), and emits ready-to-upload
// uint8 NHWC net inputs in SUBMISSION ORDER (the WQueueOrderer role) — all
// outside the Python GIL.  VGG normalization (x/256 - 0.5, openCv.cpp:57)
// happens on-device, fused by XLA into the first conv: shipping uint8
// instead of float32 quarters host->device transfer volume.
//
// C ABI for ctypes:
//   fp_create(threads, capacity, net_w, net_h) -> handle
//   fp_submit_file(h, path)            -> seq id (or -1)
//   fp_submit_bytes(h, data, len)      -> seq id (or -1)
//   fp_next(h, out_uint8, scale_out, wh_out, timeout_ms) -> seq id / -1
//   fp_pending(h)                      -> #items submitted but not popped
//   fp_destroy(h)
//
// Build: make -C native   (produces libframe_pump.so)

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>
#include <opencv2/videoio.hpp>

namespace {

struct Job {
    long seq;
    std::string path;           // or raw bytes
    std::vector<unsigned char> bytes;
};

struct Result {
    std::vector<unsigned char> data;  // [net_h, net_w, 3] BGR uint8
    double scale;               // input -> net scale factor
    int src_w, src_h;
    bool ok;
};

class FramePump {
  public:
    FramePump(int threads, int capacity, int net_w, int net_h)
        : capacity_(capacity), net_w_(net_w), net_h_(net_h) {
        for (int i = 0; i < threads; ++i)
            workers_.emplace_back([this] { workerLoop(); });
    }

    ~FramePump() {
        {
            std::lock_guard<std::mutex> lock(mutex_);
            stopping_ = true;
        }
        cv_jobs_.notify_all();
        cv_results_.notify_all();
        cv_space_.notify_all();
        for (auto& w : workers_) w.join();
    }

    long submitFile(const char* path) {
        Job job;
        job.path = path;
        return submit(std::move(job));
    }

    long submitBytes(const unsigned char* data, int len) {
        Job job;
        job.bytes.assign(data, data + len);
        return submit(std::move(job));
    }

    // Pops the next result in submission order; returns seq or -1 on timeout.
    long next(unsigned char* out, double* scale_out, int* wh_out,
              int timeout_ms) {
        std::unique_lock<std::mutex> lock(mutex_);
        const bool got = cv_results_.wait_for(
            lock, std::chrono::milliseconds(timeout_ms), [this] {
                return stopping_ || results_.count(next_pop_) > 0;
            });
        if (!got || stopping_ || results_.count(next_pop_) == 0)
            return -1;
        Result res = std::move(results_[next_pop_]);
        results_.erase(next_pop_);
        const long seq = next_pop_++;
        in_system_--;
        lock.unlock();
        cv_space_.notify_one();
        if (!res.ok)
            return -2;
        std::memcpy(out, res.data.data(), res.data.size());
        if (scale_out) *scale_out = res.scale;
        if (wh_out) { wh_out[0] = res.src_w; wh_out[1] = res.src_h; }
        return seq;
    }

    long pending() {
        std::lock_guard<std::mutex> lock(mutex_);
        return in_system_;
    }

  private:
    long submit(Job&& job) {
        std::unique_lock<std::mutex> lock(mutex_);
        cv_space_.wait(lock, [this] {
            return stopping_ || in_system_ < capacity_;
        });
        if (stopping_)
            return -1;
        job.seq = next_seq_++;
        in_system_++;
        jobs_.push_back(std::move(job));
        const long seq = jobs_.back().seq;
        lock.unlock();
        cv_jobs_.notify_one();
        return seq;
    }

    void workerLoop() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lock(mutex_);
                cv_jobs_.wait(lock, [this] {
                    return stopping_ || !jobs_.empty();
                });
                if (stopping_)
                    return;
                job = std::move(jobs_.front());
                jobs_.pop_front();
            }
            Result res = process(job);
            {
                std::lock_guard<std::mutex> lock(mutex_);
                results_[job.seq] = std::move(res);
            }
            cv_results_.notify_all();
        }
    }

    Result process(const Job& job) {
        Result res;
        res.ok = false;
        cv::Mat img = job.bytes.empty()
            ? cv::imread(job.path, cv::IMREAD_COLOR)
            : cv::imdecode(job.bytes, cv::IMREAD_COLOR);
        if (img.empty())
            return res;
        res.src_w = img.cols;
        res.src_h = img.rows;
        // resizeGetScaleFactor (openCv.cpp:182-189)
        const double ratio_w = (net_w_ - 1) / (double)(img.cols - 1);
        const double ratio_h = (net_h_ - 1) / (double)(img.rows - 1);
        const double scale = std::min(ratio_w, ratio_h);
        res.scale = scale;
        // resizeFixedAspectRatio (openCvPrivate.cpp:34-53)
        cv::Mat m = cv::Mat::eye(2, 3, CV_64F);
        m.at<double>(0, 0) = scale;
        m.at<double>(1, 1) = scale;
        cv::Mat resized;
        cv::warpAffine(img, resized, m, cv::Size(net_w_, net_h_),
                       (scale > 1. ? cv::INTER_CUBIC : cv::INTER_AREA),
                       cv::BORDER_CONSTANT, cv::Scalar(0, 0, 0));
        // HWC uint8 (the device layout is NHWC); normalization is on-device
        res.data.assign(resized.data,
                        resized.data + (size_t)net_h_ * net_w_ * 3);
        res.ok = true;
        return res;
    }

    const int capacity_, net_w_, net_h_;
    std::vector<std::thread> workers_;
    std::deque<Job> jobs_;
    std::map<long, Result> results_;
    std::mutex mutex_;
    std::condition_variable cv_jobs_, cv_results_, cv_space_;
    long next_seq_ = 0;
    long next_pop_ = 0;
    long in_system_ = 0;
    bool stopping_ = false;
};

// VideoPump: sequential native decode (cv::VideoCapture) + parallel
// preprocessing, emitting BOTH the original BGR frame (for rendering/output,
// the reference Datum::cvInputData) and the ready net input in frame order.
// Counterpart of VideoCaptureReader + WDatumProducer
// (src/openpose/producer/videoCaptureReader.cpp, datumProducer.hpp).
class VideoPump {
  public:
    VideoPump(const char* path, int threads, int capacity,
              int net_w, int net_h, int frame_step, int frame_offset = 0)
        : capacity_(capacity), net_w_(net_w), net_h_(net_h),
          step_(frame_step < 1 ? 1 : frame_step),
          offset_(frame_offset < 0 ? 0 : frame_offset), cap_(path) {
        if (!cap_.isOpened()) {
            failed_ = true;
            return;
        }
        src_w_ = (int)cap_.get(cv::CAP_PROP_FRAME_WIDTH);
        src_h_ = (int)cap_.get(cv::CAP_PROP_FRAME_HEIGHT);
        fps_ = cap_.get(cv::CAP_PROP_FPS);
        frame_count_ = (long)cap_.get(cv::CAP_PROP_FRAME_COUNT);
        decoder_ = std::thread([this] { decodeLoop(); });
        for (int i = 0; i < threads; ++i)
            workers_.emplace_back([this] { workerLoop(); });
    }

    ~VideoPump() {
        {
            std::lock_guard<std::mutex> lock(mutex_);
            stopping_ = true;
        }
        cv_jobs_.notify_all();
        cv_results_.notify_all();
        cv_space_.notify_all();
        if (decoder_.joinable()) decoder_.join();
        for (auto& w : workers_) w.join();
    }

    bool failed() const { return failed_; }
    double fps() const { return fps_; }
    long frameCount() const { return frame_count_; }
    int srcW() const { return src_w_; }
    int srcH() const { return src_h_; }

    // Returns seq >= 0 with net input + original frame; -1 timeout; -3 EOF.
    // frame_out == nullptr skips the original-frame copy (~2.7 MB per HD
    // frame) for consumers that only need the net input — the keypoint-only
    // pipeline (no rendering) saves a memcpy per frame on the hot path.
    long next(unsigned char* net_out, unsigned char* frame_out,
              double* scale_out, int timeout_ms) {
        std::unique_lock<std::mutex> lock(mutex_);
        const bool got = cv_results_.wait_for(
            lock, std::chrono::milliseconds(timeout_ms), [this] {
                return stopping_ || results_.count(next_pop_) > 0
                    || (eof_ && in_flight_ == 0);
            });
        if (results_.count(next_pop_) == 0)
            return (eof_ && in_flight_ == 0) ? -3 : (got ? -1 : -1);
        Item it = std::move(results_[next_pop_]);
        results_.erase(next_pop_);
        const long seq = next_pop_++;
        in_flight_--;
        lock.unlock();
        cv_space_.notify_one();
        std::memcpy(net_out, it.net.data(), it.net.size());
        if (frame_out)
            std::memcpy(frame_out, it.frame.data, it.frame.total() * 3);
        if (scale_out) *scale_out = it.scale;
        return seq;
    }

    // Pops up to max_n in-order results into a contiguous [n, net_h,
    // net_w, 3] buffer — ONE ctypes call (GIL released) per device batch
    // instead of one per frame; the per-frame condvar/np.empty/ctypes
    // churn was ~15% of the pump-bound pipeline on a 2-core host.
    // Returns the count popped (may be < max_n on timeout), or -3 at EOF
    // with nothing left.
    long nextBatch(unsigned char* net_out, double* scales_out, long max_n,
                   int timeout_ms) {
        const size_t frame_bytes = (size_t)net_h_ * net_w_ * 3;
        long count = 0;
        std::unique_lock<std::mutex> lock(mutex_);
        while (count < max_n) {
            cv_results_.wait_for(
                lock, std::chrono::milliseconds(timeout_ms), [this] {
                    return stopping_ || results_.count(next_pop_) > 0
                        || (eof_ && in_flight_ == 0);
                });
            if (results_.count(next_pop_) == 0) {
                if (eof_ && in_flight_ == 0)
                    return count ? count : -3;
                return count;          // timeout with a partial batch
            }
            Item it = std::move(results_[next_pop_]);
            results_.erase(next_pop_);
            next_pop_++;
            in_flight_--;
            lock.unlock();
            cv_space_.notify_one();
            std::memcpy(net_out + count * frame_bytes, it.net.data(),
                        it.net.size());
            if (scales_out) scales_out[count] = it.scale;
            count++;
            lock.lock();
        }
        return count;
    }

  private:
    struct Item {
        cv::Mat frame;
        std::vector<unsigned char> net;
        double scale;
    };

    void decodeLoop() {
        long seq = 0;
        long raw_index = 0;
        for (;;) {
            // grab() advances the stream without JPEG-decoding the frame;
            // retrieve() decodes only kept frames — stepped/striped readers
            // (frame_step N, offset k) pay 1/N of the decode cost, which is
            // what makes StripedVideoPump scale single-stream decode.
            if (!cap_.grab()) {
                std::lock_guard<std::mutex> lock(mutex_);
                eof_ = true;
                cv_results_.notify_all();
                return;
            }
            const bool keep = raw_index >= offset_
                && (raw_index - offset_) % step_ == 0;
            raw_index++;
            if (!keep)
                continue;
            cv::Mat frame;
            if (!cap_.retrieve(frame)) {
                std::lock_guard<std::mutex> lock(mutex_);
                eof_ = true;
                cv_results_.notify_all();
                return;
            }
            std::unique_lock<std::mutex> lock(mutex_);
            cv_space_.wait(lock, [this] {
                return stopping_ || in_flight_ < capacity_;
            });
            if (stopping_)
                return;
            in_flight_++;
            jobs_.emplace_back(seq++, std::move(frame));
            lock.unlock();
            cv_jobs_.notify_one();
        }
    }

    void workerLoop() {
        for (;;) {
            std::pair<long, cv::Mat> job;
            {
                std::unique_lock<std::mutex> lock(mutex_);
                cv_jobs_.wait(lock, [this] {
                    return stopping_ || !jobs_.empty();
                });
                if (stopping_)
                    return;
                job = std::move(jobs_.front());
                jobs_.pop_front();
            }
            Item it;
            it.frame = job.second;
            const double ratio_w = (net_w_ - 1) / (double)(it.frame.cols - 1);
            const double ratio_h = (net_h_ - 1) / (double)(it.frame.rows - 1);
            it.scale = std::min(ratio_w, ratio_h);
            cv::Mat m = cv::Mat::eye(2, 3, CV_64F);
            m.at<double>(0, 0) = it.scale;
            m.at<double>(1, 1) = it.scale;
            // warp straight into the result buffer (no intermediate Mat +
            // 724 KB assign per frame)
            it.net.resize((size_t)net_h_ * net_w_ * 3);
            cv::Mat resized(net_h_, net_w_, CV_8UC3, it.net.data());
            cv::warpAffine(it.frame, resized, m, cv::Size(net_w_, net_h_),
                           (it.scale > 1. ? cv::INTER_CUBIC : cv::INTER_AREA),
                           cv::BORDER_CONSTANT, cv::Scalar(0, 0, 0));
            {
                std::lock_guard<std::mutex> lock(mutex_);
                results_[job.first] = std::move(it);
            }
            cv_results_.notify_all();
        }
    }

    const int capacity_, net_w_, net_h_, step_, offset_;
    cv::VideoCapture cap_;
    bool failed_ = false;
    int src_w_ = 0, src_h_ = 0;
    double fps_ = 0.0;
    long frame_count_ = 0;
    std::thread decoder_;
    std::vector<std::thread> workers_;
    std::deque<std::pair<long, cv::Mat>> jobs_;
    std::map<long, Item> results_;
    std::mutex mutex_;
    std::condition_variable cv_jobs_, cv_results_, cv_space_;
    long next_pop_ = 0;
    std::atomic<long> in_flight_{0};
    bool eof_ = false;
    bool stopping_ = false;
};

}  // namespace

extern "C" {

void* vp_create(const char* path, int threads, int capacity,
                int net_w, int net_h, int frame_step) {
    auto* vp = new VideoPump(path, threads, capacity, net_w, net_h,
                             frame_step);
    if (vp->failed()) {
        delete vp;
        return nullptr;
    }
    return vp;
}

void* vp_create2(const char* path, int threads, int capacity,
                 int net_w, int net_h, int frame_step, int frame_offset) {
    auto* vp = new VideoPump(path, threads, capacity, net_w, net_h,
                             frame_step, frame_offset);
    if (vp->failed()) {
        delete vp;
        return nullptr;
    }
    return vp;
}

long vp_next(void* handle, unsigned char* net_out, unsigned char* frame_out,
             double* scale_out, int timeout_ms) {
    return static_cast<VideoPump*>(handle)->next(net_out, frame_out,
                                                 scale_out, timeout_ms);
}

long vp_next_batch(void* handle, unsigned char* net_out, double* scales_out,
                   long max_n, int timeout_ms) {
    return static_cast<VideoPump*>(handle)->nextBatch(net_out, scales_out,
                                                      max_n, timeout_ms);
}

double vp_fps(void* handle) {
    return static_cast<VideoPump*>(handle)->fps();
}

long vp_frame_count(void* handle) {
    return static_cast<VideoPump*>(handle)->frameCount();
}

void vp_size(void* handle, int* w, int* h) {
    *w = static_cast<VideoPump*>(handle)->srcW();
    *h = static_cast<VideoPump*>(handle)->srcH();
}

void vp_destroy(void* handle) {
    delete static_cast<VideoPump*>(handle);
}

void* fp_create(int threads, int capacity, int net_w, int net_h) {
    return new FramePump(threads, capacity, net_w, net_h);
}

long fp_submit_file(void* handle, const char* path) {
    return static_cast<FramePump*>(handle)->submitFile(path);
}

long fp_submit_bytes(void* handle, const unsigned char* data, int len) {
    return static_cast<FramePump*>(handle)->submitBytes(data, len);
}

long fp_next(void* handle, unsigned char* out, double* scale_out,
             int* wh_out, int timeout_ms) {
    return static_cast<FramePump*>(handle)->next(out, scale_out, wh_out,
                                                 timeout_ms);
}

long fp_pending(void* handle) {
    return static_cast<FramePump*>(handle)->pending();
}

void fp_destroy(void* handle) {
    delete static_cast<FramePump*>(handle);
}

}  // extern "C"
