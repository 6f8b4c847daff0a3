// The score kernel's study build: score.cu compiled with its store floor
// (koord_score_floor: a kernel that only writes the two [P, N] outputs, in
// the score kernel's layout) and its launch under any strip height and
// block width (koord_score_tuned), for `chip_smoke.py --score`.  No path of the
// port loads it: cuda.build compiles it only when a study binds one of its
// entry points (cuda.STUDY), and the library the paths launch carries none
// of this.
#define KOORD_SCORE_STUDY
#include "score.cu"
