// Asynchronous snapshot writer: the port's own copy of the reference's
// native/snapwriter.cpp (SURVEY.md §3 C16).
//
// A synchronous host write of a snapshot would hold the Python run loop
// for tens of milliseconds, during which it queues no work for the card.
// Here snapshot buffers are copied into a bounded in-memory queue and
// written to disk by a dedicated writer thread, so the run loop returns
// to launching kernels at once.  Exposed to Python through ctypes
// (beom_tpu_torch/io/native.py, which builds it into build/native/).
//
// Build:  g++ -O3 -shared -fPIC -pthread -o libsnapwriter.so snapwriter.cpp

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::string path;
    std::vector<uint8_t> data;   // owned copy
};

struct Writer {
    std::thread thread;
    std::mutex mu;
    std::condition_variable cv;
    std::deque<Job> queue;
    size_t max_queued_bytes;
    size_t queued_bytes = 0;
    bool shutdown = false;
    bool busy = false;      // a popped job is still being written
    long errors = 0;

    explicit Writer(size_t max_bytes) : max_queued_bytes(max_bytes) {
        thread = std::thread([this] { run(); });
    }

    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return shutdown || !queue.empty(); });
                if (queue.empty()) {
                    if (shutdown) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
                queued_bytes -= job.data.size();
                busy = true;       // flush() must wait for this write
                cv.notify_all();   // wake any producer blocked on space
            }
            FILE* f = std::fopen(job.path.c_str(), "wb");
            bool ok = false;
            if (f) {
                size_t n = std::fwrite(job.data.data(), 1,
                                       job.data.size(), f);
                ok = (std::fclose(f) == 0) && (n == job.data.size());
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                if (!ok) ++errors;
                busy = false;
            }
            cv.notify_all();
        }
    }

    // Blocks only when the queue is full (backpressure), not on disk.
    void submit(const char* path, const void* data, size_t nbytes) {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this, nbytes] {
            return queued_bytes + nbytes <= max_queued_bytes ||
                   queue.empty();
        });
        Job job;
        job.path = path;
        job.data.assign(static_cast<const uint8_t*>(data),
                        static_cast<const uint8_t*>(data) + nbytes);
        queued_bytes += job.data.size();
        queue.push_back(std::move(job));
        cv.notify_all();
    }

    void flush() {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [this] { return queue.empty() && !busy; });
    }

    ~Writer() {
        {
            std::lock_guard<std::mutex> lk(mu);
            shutdown = true;
        }
        cv.notify_all();
        if (thread.joinable()) thread.join();
    }
};

}  // namespace

extern "C" {

void* sw_open(size_t max_queued_bytes) {
    return new Writer(max_queued_bytes ? max_queued_bytes
                                       : (size_t)1 << 30);
}

void sw_submit(void* w, const char* path, const void* data,
               size_t nbytes) {
    static_cast<Writer*>(w)->submit(path, data, nbytes);
}

void sw_flush(void* w) { static_cast<Writer*>(w)->flush(); }

long sw_errors(void* w) {
    Writer* wr = static_cast<Writer*>(w);
    std::lock_guard<std::mutex> lk(wr->mu);
    return wr->errors;
}

void sw_close(void* w) { delete static_cast<Writer*>(w); }

}  // extern "C"
