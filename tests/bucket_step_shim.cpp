// Runs csrc/bucket_step.cu's kernel on the host under cuda_shim.h, for
// tests/test_torch_bucket_shim.py:
//
//   bucket_step_shim IN OUT
//
// IN holds, packed: the Layout struct (bucket_step.Layout's bytes), the
// int32s replicas, b0 and nb, then float32 consts (NC), prm (R x K),
// carry (R x F) and xs (nb x X).  OUT receives float32 out (R x F) and
// ys (R x nb x Y).  The kernel is chosen by the launcher's own dispatch.
#include "../src/repro_torch/kernels/csrc/bucket_step.cu"

#include <cstdio>
#include <vector>

namespace {

struct HostRun {
  bucket_step::Layout lay;
  const float *consts, *prm, *carry, *xs;
  float *out, *ys;
  int replicas, b0, nb;

  template <int JT, int CPL, int CT = 0, int PT = 0>
  int go() const {
    const Plan plan = smem_plan(lay);
    const long long floats = smem_floats(lay, plan.stride, plan.ybufs);
    shim::launch(replicas, NT, static_cast<std::size_t>(floats), [&] {
      bucket_segment_kernel<JT, CPL, CT, PT>(lay, consts, prm, carry, out,
                                             xs, ys, b0, nb);
    });
    return 0;
  }
};

bool read_all(std::FILE* f, void* dst, std::size_t bytes) {
  return std::fread(dst, 1, bytes, f) == bytes;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) return 2;
  std::FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 3;
  HostRun run{};
  int dims[3];
  if (!read_all(in, &run.lay, sizeof run.lay) ||
      !read_all(in, dims, sizeof dims))
    return 4;
  run.replicas = dims[0];
  run.b0 = dims[1];
  run.nb = dims[2];
  const bucket_step::Layout& l = run.lay;
  const std::size_t R = run.replicas, nb = run.nb;
  std::vector<float> consts(l.NC), prm(R * l.K), carry(R * l.F),
      xs(nb * l.X), out(R * l.F), ys(R * nb * l.Y);
  if (!read_all(in, consts.data(), consts.size() * 4) ||
      !read_all(in, prm.data(), prm.size() * 4) ||
      !read_all(in, carry.data(), carry.size() * 4) ||
      !read_all(in, xs.data(), xs.size() * 4))
    return 5;
  std::fclose(in);
  run.consts = consts.data();
  run.prm = prm.data();
  run.carry = carry.data();
  run.xs = xs.data();
  run.out = out.data();
  run.ys = ys.data();
  dispatch(l, run);
  std::FILE* o = std::fopen(argv[2], "wb");
  if (!o) return 6;
  std::fwrite(out.data(), 4, out.size(), o);
  std::fwrite(ys.data(), 4, ys.size(), o);
  std::fclose(o);
  return 0;
}
