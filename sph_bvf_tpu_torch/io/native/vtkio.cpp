// Native legacy-VTK POLYDATA writer — the performance path of io/vtk.py.
//
// The port's own copy of sph_bvf_tpu/io/native/vtkio.cpp, unchanged below
// this header, so both packages write the same bytes; io/vtk.py compiles it
// with the host C++ compiler into build/sph_bvf_tpu_torch/ at first use.
// The reference's dump path is C++ (USER-VTK/dump_vtk.cpp, 2.4k LoC against
// libvtk); this is a dependency-free writer with a C ABI consumed via
// ctypes, handling both ASCII (reference-compatible) and binary (big-endian,
// ParaView-compatible) legacy VTK.  At ~1M particles the Python ASCII
// formatter is the dump bottleneck; this writer streams at fwrite speed.
//
// ABI (see io/vtk.py for the ctypes binding):
//   int vtk_write_polydata(path, title, points, n,
//                          names, fields, is_int, nfields, binary)
// fields[i] points at n floats (is_int[i]==0) or n int32s (is_int[i]==1).
// Returns 0 on success, negative errno-style codes otherwise.

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint32_t to_be(uint32_t v) {
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  return __builtin_bswap32(v);
#else
  return v;
#endif
}

inline uint32_t be_f32(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return to_be(u);
}

inline uint32_t be_i32(int32_t i) {
  uint32_t u;
  std::memcpy(&u, &i, 4);
  return to_be(u);
}

void write_be_block_f32(FILE* f, const float* data, long count) {
  std::vector<uint32_t> buf(static_cast<size_t>(count));
  for (long i = 0; i < count; ++i) buf[static_cast<size_t>(i)] = be_f32(data[i]);
  std::fwrite(buf.data(), 4, static_cast<size_t>(count), f);
}

void write_be_block_i32(FILE* f, const int32_t* data, long count) {
  std::vector<uint32_t> buf(static_cast<size_t>(count));
  for (long i = 0; i < count; ++i) buf[static_cast<size_t>(i)] = be_i32(data[i]);
  std::fwrite(buf.data(), 4, static_cast<size_t>(count), f);
}

void write_ascii_f32(FILE* f, const float* data, long count, int per_line) {
  for (long i = 0; i < count; ++i) {
    std::fprintf(f, "%.9g%c", static_cast<double>(data[i]),
                 (i % per_line == per_line - 1 || i == count - 1) ? '\n' : ' ');
  }
}

}  // namespace

extern "C" int vtk_write_polydata(
    const char* path, const char* title,
    const float* points, long n,
    const char** names, const void** fields, const int* is_int,
    long nfields, int binary) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;

  std::fprintf(f, "# vtk DataFile Version 3.0\n%s\n%s\nDATASET POLYDATA\n",
               title, binary ? "BINARY" : "ASCII");
  std::fprintf(f, "POINTS %ld float\n", n);
  if (binary) {
    write_be_block_f32(f, points, 3 * n);
    std::fputc('\n', f);
  } else {
    write_ascii_f32(f, points, 3 * n, 3);
  }

  std::fprintf(f, "VERTICES %ld %ld\n", n, 2 * n);
  if (binary) {
    std::vector<uint32_t> buf(static_cast<size_t>(2 * n));
    for (long i = 0; i < n; ++i) {
      buf[static_cast<size_t>(2 * i)] = be_i32(1);
      buf[static_cast<size_t>(2 * i + 1)] = be_i32(static_cast<int32_t>(i));
    }
    std::fwrite(buf.data(), 4, static_cast<size_t>(2 * n), f);
    std::fputc('\n', f);
  } else {
    for (long i = 0; i < n; ++i) std::fprintf(f, "1 %ld\n", i);
  }

  std::fprintf(f, "POINT_DATA %ld\n", n);
  for (long k = 0; k < nfields; ++k) {
    std::fprintf(f, "SCALARS %s %s\nLOOKUP_TABLE default\n", names[k],
                 is_int[k] ? "int" : "float");
    if (binary) {
      if (is_int[k]) {
        write_be_block_i32(f, static_cast<const int32_t*>(fields[k]), n);
      } else {
        write_be_block_f32(f, static_cast<const float*>(fields[k]), n);
      }
      std::fputc('\n', f);
    } else if (is_int[k]) {
      const int32_t* d = static_cast<const int32_t*>(fields[k]);
      for (long i = 0; i < n; ++i) std::fprintf(f, "%d\n", d[i]);
    } else {
      write_ascii_f32(f, static_cast<const float*>(fields[k]), n, 1);
    }
  }

  int rc = std::ferror(f) ? -2 : 0;
  std::fclose(f);
  return rc;
}
