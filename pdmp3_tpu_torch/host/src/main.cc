// pdmp3 CLI: decode MP3 files to <file>.raw (or stdout with "-").
#include "../include/pdmp3.h"

int main(int argc, char *argv[]) {
  (void)argc;
  pdmp3(++argv);
  return 0;
}
