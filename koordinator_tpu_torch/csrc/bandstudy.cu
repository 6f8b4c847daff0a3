// The band order's study build: bandrank.cu compiled with its split (block
// 0's global nanosecond timer at each step of the sort; read by
// koord_band_split), for `chip_smoke.py --band`.  No path of the port loads
// it: cuda.build compiles it only when a study binds one of its entry
// points (cuda.STUDY), and the library the paths launch carries none of
// this.
#define KOORD_BAND_STUDY
#include "bandrank.cu"
