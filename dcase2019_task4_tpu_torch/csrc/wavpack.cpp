// Native host-side audio batcher for the device feed path (the port's copy of
// dcase2019_task4_tpu/native/wavpack.cpp).
//
// The hot host work between disk and device is: read WAV → decode PCM →
// mono-mix → reflect-pad (librosa center-pad semantics, n_fft/2 each side)
// → pack into a fixed [B, max_samples + n_fft] int16 buffer ready for
// the host-to-device copy. The reference does the analogous work per clip in Python
// with librosa/soundfile (DatasetDcase2019Task4.py:233-269, read_audio
// utils/utils.py:175-193); here it is one C++ call per batch with a thread
// pool, writing straight into the final buffer with no intermediate Python
// objects.
//
// Supported: RIFF/WAVE, PCM 16-bit and IEEE float 32-bit, any channel
// count (averaged to mono), sample rate must already match the target
// (the pipeline's Python fallback handles resampling of odd files).
//
// Exposed functions (CPython C API, no third-party binding dep):
//   pack_batch(paths: list[str], max_samples: int, n_fft: int, hop: int,
//              target_sr: int, n_threads: int)
//     -> (buffer: bytes int16 [B, max_samples+n_fft],
//         frames: bytes int32 [B],   # valid frame counts (1 + n//hop)
//         errors: list[str])         # "" per file on success
//   decode_wav(path: str, target_sr: int) -> (bytes int16 mono, sr, err)

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodeResult {
  std::vector<int16_t> samples;  // mono, int16
  int sample_rate = 0;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

DecodeResult decode_wav_file(const std::string& path, int target_sr) {
  DecodeResult out;
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    out.error = "cannot open file";
    return out;
  }
  std::vector<uint8_t> data((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  if (data.size() < 44 || std::memcmp(data.data(), "RIFF", 4) != 0 ||
      std::memcmp(data.data() + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }
  size_t pos = 12;
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t sr = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  while (pos + 8 <= data.size()) {
    const uint8_t* hdr = data.data() + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > data.size())
      chunk_len = (uint32_t)(data.size() - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt = rd_u16(body);
      channels = rd_u16(body + 2);
      sr = rd_u32(body + 4);
      bits = rd_u16(body + 14);
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are 2-byte aligned
  }
  if (!pcm || channels == 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  if ((int)sr != target_sr) {
    out.error = "sample rate mismatch: " + std::to_string(sr);
    return out;
  }
  if (fmt == 1 && bits == 16) {
    size_t n = pcm_len / (2 * channels);
    out.samples.resize(n);
    const int16_t* s = reinterpret_cast<const int16_t*>(pcm);
    if (channels == 1) {
      std::memcpy(out.samples.data(), s, n * 2);
    } else {
      // float mean + round-to-nearest-even, matching the Python pipeline's
      // float mono-mix then int16 quantization
      for (size_t i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int c = 0; c < channels; ++c) acc += (float)s[i * channels + c];
        out.samples[i] = (int16_t)lrintf(acc / channels);
      }
    }
  } else if (fmt == 3 && bits == 32) {
    size_t n = pcm_len / (4 * channels);
    out.samples.resize(n);
    const float* s = reinterpret_cast<const float*>(pcm);
    for (size_t i = 0; i < n; ++i) {
      float acc = 0.f;
      for (int c = 0; c < channels; ++c) acc += s[i * channels + c];
      float v = acc / channels * 32768.0f;
      if (v > 32767.f) v = 32767.f;
      if (v < -32768.f) v = -32768.f;
      out.samples[i] = (int16_t)lrintf(v);
    }
  } else {
    out.error = "unsupported format (fmt=" + std::to_string(fmt) +
                ", bits=" + std::to_string(bits) + ")";
    return out;
  }
  out.sample_rate = (int)sr;
  return out;
}

// Reflect-pad `src` by `pad` samples on each side into `dst` (librosa
// center=True 'reflect': left = src[pad..1], right = src[n-2..]), cropping
// to dst_len. Zero-fills the remainder.
void reflect_pack(const int16_t* src, int64_t n, int16_t* dst, int64_t dst_len,
                  int64_t pad) {
  std::memset(dst, 0, sizeof(int16_t) * dst_len);
  if (n <= 0) return;
  int64_t w = 0;
  auto put = [&](int64_t idx) {
    if (w < dst_len) dst[w++] = src[idx];
  };
  if (n > 1) {
    for (int64_t i = pad; i >= 1 && w < dst_len; --i) put(i < n ? i : n - 1);
  } else {
    for (int64_t i = 0; i < pad && w < dst_len; ++i) put(0);
  }
  int64_t copy = n < (dst_len - w) ? n : (dst_len - w);
  std::memcpy(dst + w, src, sizeof(int16_t) * copy);
  w += copy;
  // right reflection: exactly `pad` samples (np.pad adds pad, no more);
  // the remainder of the row stays zero (PadOrTrunc semantics)
  int64_t right = 0;
  for (int64_t i = n - 2; i >= 0 && right < pad && w < dst_len; --i, ++right)
    dst[w++] = src[i];
}

}  // namespace

extern "C" {

static PyObject* py_decode_wav(PyObject*, PyObject* args) {
  const char* path;
  int target_sr;
  if (!PyArg_ParseTuple(args, "si", &path, &target_sr)) return nullptr;
  DecodeResult r;
  Py_BEGIN_ALLOW_THREADS
  r = decode_wav_file(path, target_sr);
  Py_END_ALLOW_THREADS
  PyObject* buf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(r.samples.data()),
      (Py_ssize_t)(r.samples.size() * 2));
  return Py_BuildValue("(Nis)", buf, r.sample_rate, r.error.c_str());
}

static PyObject* py_pack_batch(PyObject*, PyObject* args) {
  PyObject* path_list;
  long max_samples, n_fft, hop, target_sr, n_threads;
  if (!PyArg_ParseTuple(args, "Olllll", &path_list, &max_samples, &n_fft, &hop,
                        &target_sr, &n_threads))
    return nullptr;
  if (!PyList_Check(path_list)) {
    PyErr_SetString(PyExc_TypeError, "paths must be a list of str");
    return nullptr;
  }
  Py_ssize_t B = PyList_Size(path_list);
  std::vector<std::string> paths((size_t)B);
  for (Py_ssize_t i = 0; i < B; ++i) {
    PyObject* it = PyList_GetItem(path_list, i);
    const char* s = PyUnicode_AsUTF8(it);
    if (!s) return nullptr;
    paths[(size_t)i] = s;
  }
  const int64_t pad = n_fft / 2;
  const int64_t row = max_samples + n_fft;  // pad both sides
  const int64_t max_frames = 1 + max_samples / hop;
  std::vector<int16_t> buffer((size_t)(B * row), 0);
  std::vector<int32_t> frames((size_t)B, 0);
  std::vector<std::string> errors((size_t)B);

  Py_BEGIN_ALLOW_THREADS {
    std::atomic<Py_ssize_t> next(0);
    auto worker = [&]() {
      while (true) {
        Py_ssize_t i = next.fetch_add(1);
        if (i >= B) break;
        DecodeResult r = decode_wav_file(paths[(size_t)i], (int)target_sr);
        if (!r.error.empty()) {
          errors[(size_t)i] = r.error;
          continue;
        }
        int64_t n = (int64_t)r.samples.size();
        int64_t nf = 1 + n / hop;
        frames[(size_t)i] = (int32_t)(nf < max_frames ? nf : max_frames);
        // cap so the last frame still has real data (matches
        // ops/mel.host_reflect_pad's max_samples + pad crop)
        if (n > max_samples + pad) n = max_samples + pad;
        reflect_pack(r.samples.data(), n, buffer.data() + i * row, row, pad);
      }
    };
    int nt = (int)n_threads;
    if (nt < 1) nt = 1;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  Py_END_ALLOW_THREADS

  PyObject* pybuf = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(buffer.data()),
      (Py_ssize_t)(buffer.size() * 2));
  PyObject* pyframes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(frames.data()),
      (Py_ssize_t)(frames.size() * 4));
  PyObject* pyerr = PyList_New(B);
  for (Py_ssize_t i = 0; i < B; ++i)
    PyList_SetItem(pyerr, i, PyUnicode_FromString(errors[(size_t)i].c_str()));
  return Py_BuildValue("(NNN)", pybuf, pyframes, pyerr);
}

static PyMethodDef Methods[] = {
    {"decode_wav", py_decode_wav, METH_VARARGS,
     "decode_wav(path, target_sr) -> (int16 bytes, sr, error)"},
    {"pack_batch", py_pack_batch, METH_VARARGS,
     "pack_batch(paths, max_samples, n_fft, hop, target_sr, n_threads) -> "
     "(int16 bytes [B,row], int32 bytes [B], errors)"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_wavpack",
                                       "native WAV batch packer", -1, Methods};

PyMODINIT_FUNC PyInit__wavpack(void) { return PyModule_Create(&moduledef); }

}  // extern "C"
