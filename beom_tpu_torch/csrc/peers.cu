// Peer access between the cards of a device mesh: the shard kernels (K7)
// and the halo pad (K8) of one card read the edges of its neighbour cards'
// shards through their pointers, valid under unified addressing once the
// reading card has enabled access to the card that holds them.

#include <cuda_runtime.h>

// let device `dev` read the memory of device `peer`; access that is
// already on counts as success
extern "C" int beom_enable_peer(int dev, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return int(e);
  e = cudaSetDevice(dev);
  if (e == cudaSuccess) {
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      e = cudaSuccess;
    }
  }
  const cudaError_t back = cudaSetDevice(prev);
  return int(e != cudaSuccess ? e : back);
}

extern "C" const char* beom_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
